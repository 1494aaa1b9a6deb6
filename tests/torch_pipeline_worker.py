"""Stage 1 of tests/test_torch_pipeline.py's two-stage run.

Not a test module (no ``test_`` prefix): the test process is stage 0 (rank
0) and starts this one as stage 1 with the ``spawn`` method. It joins the
pp=2 gloo mesh over the test's store, draws its cut of the seeded weights
(``init_params_shard``: layers ``[L/2, L)``), makes its cache slice, then
runs the ops the test sends, each the later stage's half of what stage 0
runs: ``prefill`` (:func:`follow_staged_prefill`), ``decode``
(:func:`follow_staged_decode`) and ``cache`` (its cache slice back, as
numpy). Imports the port and torch only.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def stage(port: int, spec, seed: int, rows: int, ops, out) -> None:
    import datetime

    import torch
    import torch.distributed as dist

    from quorum_tpu_torch.models.init import init_params_shard
    from quorum_tpu_torch.models.transformer import init_cache
    from quorum_tpu_torch.parallel import MeshConfig, make_mesh
    from quorum_tpu_torch.parallel.comm import join
    from quorum_tpu_torch.parallel.pipeline import follow_staged_decode, follow_staged_prefill

    torch.set_num_threads(1)
    mesh = make_mesh(MeshConfig(pp=2), ["cpu", "cpu"])
    store = dist.TCPStore("127.0.0.1", port, 2, False, timeout=datetime.timedelta(seconds=60))
    rmesh = join(mesh, 1, store)
    blocks = init_params_shard(spec, seed, mesh, 1, "cpu")["blocks"]
    ck, cv = init_cache(spec, rows, device="cpu", layers=spec.n_layers // 2)
    with torch.no_grad():
        while True:
            op = ops.get(timeout=120)
            if op[0] == "stop":
                break
            if op[0] == "prefill":
                _, length, bucket, slot = op
                lengths = torch.tensor([length], dtype=torch.int32)
                follow_staged_prefill(blocks, spec, (1, bucket, spec.d_model), lengths, ck, cv,
                                      slot, rmesh)
            elif op[0] == "decode":
                _, n_steps, n_chunks = op
                out.put(follow_staged_decode(blocks, spec, rmesh, n_steps, n_chunks, rows,
                                             ck, cv))
            elif op[0] == "cache":
                out.put((ck.numpy().copy(), cv.numpy().copy()))
    rmesh.shutdown(10.0)
