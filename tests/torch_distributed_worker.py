"""Worker process of tests/test_torch_distributed.py's four-process run.

Not a test module (no ``test_`` prefix): launched four times with
torchrun's variables (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``) as 2 hosts × 2 ranks. Each
process joins the run through the port's ``parallel/distributed`` helpers,
lays the hybrid mesh (tp=2 within a host, dp=2 across the hosts), feeds
only its host's rows and runs one training step of llama-tiny on the CPU:
the dp gradient all-reduce crosses between the hosts. Prints one JSON line
the test reads. Imports the port and torch only.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    import numpy as np
    import torch

    from quorum_tpu_torch.models.model_config import resolve_spec
    from quorum_tpu_torch.parallel import MeshConfig
    from quorum_tpu_torch.parallel.distributed import (assemble_global_batch, hybrid_mesh,
                                                       initialize, join_mesh,
                                                       local_data_shard, process_index)
    from quorum_tpu_torch.training.trainer import make_train_step, train_init

    torch.set_num_threads(1)
    assert initialize()
    spec = resolve_spec("llama-tiny", {"dtype": "float32", "max_seq": "64"})
    mesh = hybrid_mesh(MeshConfig(tp=2), dcn_dp=2, devices=["cpu", "cpu"])
    rmesh = join_mesh(mesh)
    global_batch = 4
    tokens = np.random.default_rng(11).integers(1, spec.vocab_size, (global_batch, 17))
    tokens[1, 6:] = 0  # the hosts' real-token counts differ
    start, size = local_data_shard(global_batch)
    rows = assemble_global_batch(tokens[start:start + size], rmesh, global_batch)
    state = train_init(spec, seed=0, mesh=rmesh)
    step = make_train_step(spec, mesh=rmesh)
    state, loss = step(state, rows)
    print(json.dumps({"host": process_index(), "rank": rmesh.rank, "dp": rmesh.dp_rank,
                      "rows": rows.tolist(), "loss": float(loss)}), flush=True)
    rmesh.shutdown()


if __name__ == "__main__":
    main()
