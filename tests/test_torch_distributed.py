"""The port's ``parallel/distributed.py`` against the JAX package's
``tests/test_distributed.py``, case for case, on the CPU:

- ``initialize`` is a no-op for a single process (no torchrun variables);
- ``hybrid_mesh`` with one host is ``make_mesh``;
- ``local_data_shard`` for one process, and ``assemble_global_batch``
  giving each rank of a dp=2 × tp=2 group its dp rows;
- a dp=2 × tp=2 training step on gloo CPU ranks: its loss equals JAX's
  ``loss_fn`` on the same params and batch within 1e-5 (relative), on
  every rank;
- four processes launched with torchrun's variables as 2 hosts × 2 ranks
  (``tests/torch_distributed_worker.py``): dp spans the hosts, each host
  feeds only its rows, and every process reports the same loss, equal to
  the one-process step's within 1e-5 (relative). Every subprocess has its
  own timeout, and one failing kills its siblings.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quorum_tpu.models.init import init_params as jax_init_params
from quorum_tpu.models.model_config import resolve_spec as jax_resolve_spec
from quorum_tpu.training import trainer as jtrainer
from quorum_tpu_torch.models.model_config import resolve_spec
from quorum_tpu_torch.parallel import MeshConfig, RankGroup, make_mesh
from quorum_tpu_torch.parallel import distributed
from quorum_tpu_torch.training import trainer

TOL = 1e-5
OPTS = {"dtype": "float32", "max_seq": "64"}
TORCHRUN_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                 "LOCAL_WORLD_SIZE")


@pytest.fixture(scope="module")
def dp2_tp2():
    grp = RankGroup(make_mesh(MeshConfig(dp=2, tp=2), ["cpu"] * 4, timeout_s=60.0))
    grp.start()
    yield grp
    grp.stop()


def test_initialize_noop_single_process(monkeypatch):
    for var in TORCHRUN_VARS:
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize() is False
    assert distributed.runtime() is None and distributed.process_count() == 1


def test_hybrid_mesh_single_host_is_plain_mesh():
    cfg = MeshConfig(dp=2, tp=2)
    mesh = distributed.hybrid_mesh(cfg, dcn_dp=1, devices=["cpu"] * 4)
    assert mesh == make_mesh(cfg, ["cpu"] * 4)
    assert mesh.shape == {"dp": 2, "pp": 1, "sp": 1, "tp": 2}
    with pytest.raises(RuntimeError, match="call initialize"):
        distributed.hybrid_mesh(MeshConfig(tp=2), dcn_dp=2, devices=["cpu"] * 2)


def test_local_data_shard_single_process():
    assert distributed.local_data_shard(8) == (0, 8)


def test_assemble_global_batch_places_on_dp(dp2_tp2):
    tokens = np.arange(8 * 4, dtype=np.int64).reshape(8, 4)
    got = dp2_tp2.run("quorum_tpu_torch.parallel.distributed:assemble_global_batch",
                      [(tokens,)] * 4, [{"global_batch": 8}] * 4)
    for r, rows in enumerate(got):
        d = dp2_tp2.mesh.coords(r)["dp"]
        np.testing.assert_array_equal(rows, tokens[4 * d:4 * d + 4])


def test_dp_tp_step_loss_equals_jax_loss_fn(dp2_tp2):
    jspec = jax_resolve_spec("llama-tiny", OPTS)
    params = jax.tree.map(np.asarray, jax_init_params(jspec, seed=2))
    tokens = np.ones((4, 32), np.int64) * 7
    tokens[2, 20:] = 0
    want = float(jtrainer.loss_fn(jax.tree.map(jnp.asarray, params), jspec,
                                  jnp.asarray(tokens, jnp.int32)))
    spec = resolve_spec("llama-tiny", OPTS)
    outs = dp2_tp2.run("quorum_tpu_torch.training.trainer:train_steps", [(spec, tokens)] * 4,
                       [dict(params=params, steps=1)] * 4)
    for o in outs:
        assert np.isfinite(o["losses"][0])
        np.testing.assert_allclose(o["losses"][0], want, rtol=TOL)


def test_two_hosts_of_two_ranks_compute_the_one_process_loss():
    """The counterpart of ``test_two_process_train_step``: four processes,
    two simulated hosts, joined by torchrun's variables."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(repo, "tests", "torch_distributed_worker.py")
    with socket.socket() as s:  # a free port for the run's store
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    def spawn(rank: int) -> subprocess.Popen:
        env = dict(os.environ)
        env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="4",
                   RANK=str(rank), LOCAL_RANK=str(rank % 2), LOCAL_WORLD_SIZE="2",
                   GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
        return subprocess.Popen([sys.executable, worker], env=env, cwd=repo,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    procs = [spawn(r) for r in range(4)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-2000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        # One worker failing must not leave its siblings waiting on the store.
        for q in procs:
            if q.poll() is None:
                q.kill()
            q.communicate()
    assert sorted(o["rank"] for o in outs) == [0, 1, 2, 3]
    assert [o["host"] for o in outs] == [0, 0, 1, 1] and [o["dp"] for o in outs] == [0, 0, 1, 1]
    losses = [o["loss"] for o in outs]
    assert len(set(losses)) == 1, f"ranks disagree on the global loss: {losses}"
    spec = resolve_spec("llama-tiny", OPTS)
    tokens = np.array(outs[0]["rows"] + outs[2]["rows"])
    state = trainer.train_init(spec, device="cpu", seed=0)
    _, one = trainer.make_train_step(spec, device="cpu")(state, torch.as_tensor(tokens))
    np.testing.assert_allclose(losses[0], float(one), rtol=TOL)
