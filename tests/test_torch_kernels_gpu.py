"""The port's hand-written attention kernels on the card, against their
plain PyTorch versions (the kernels have no CPU mode: every test here is
marked ``gpu`` and skips without a card).

Run on a machine with an H100:
    python -m pytest -m gpu tests/test_torch_kernels_gpu.py

Tolerances: 1e-4 in f32 (summation order only), 2e-2 in bf16 (the plain
version rounds the probabilities to bf16 before P·V, the kernels round P
or the output at other places — a few bf16 ulps of O(1) outputs).
"""

import pytest
import torch

from quorum_tpu_torch.ops import attention as plain
from quorum_tpu_torch.ops import flash_attention as fa
from quorum_tpu_torch.ops import flash_decode as fd
from quorum_tpu_torch.ops.flash_attention import flash_prefill_attention, prefill_route

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda_device():
    """The card (decided here, never at import: the CPU suite collects this file)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


def _rnd(gen, shape, dtype, device):
    return torch.randn(shape, generator=gen).to(device, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,hd", [(torch.bfloat16, 128), (torch.bfloat16, 64),
                                      (torch.bfloat16, 256), (torch.float32, 128)])
@pytest.mark.parametrize("s", [1000, 200])
@pytest.mark.parametrize("window", [0, 256])
def test_prefill_kernel_matches_plain_and_zeroes_padding(cuda_device, dtype, hd, s, window):
    """S not a multiple of any tile; lengths 0, 1, mid-tile and full; every
    row at or past a length is exactly 0."""
    gen = torch.Generator().manual_seed(s + hd + window)
    lens = [0, 1, s // 2 + 13, s]
    b, h, kv = len(lens), 8, 2
    q = _rnd(gen, (b, h, s, hd), dtype, cuda_device)
    k, v = _rnd(gen, (b, kv, s, hd), dtype, cuda_device), _rnd(gen, (b, kv, s, hd), dtype,
                                                                    cuda_device)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    route = prefill_route(dtype, hd)
    before = flash_prefill_attention.launches_by_route[route]
    got = flash_prefill_attention(q, k, v, lengths, window=window)
    want = plain.prefill_attention(q, k, v, lengths, window=window)
    torch.cuda.synchronize()
    assert flash_prefill_attention.launches_by_route[route] == before + 1
    assert route == ("wgmma" if dtype == torch.bfloat16 and hd in (64, 128) else "fma")
    for i, n in enumerate(lens):
        if n:
            err = (got[i, :, :n].float() - want[i, :, :n].float()).abs().max().item()
            assert err <= TOL[dtype], (i, n, err)
        assert bool((got[i, :, n:] == 0).all()), f"row past length {n} not zero"
    assert all(int(c.abs().sum()) == 0 for c in fa._SCHED.values())  # counters reset


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,hd", [(torch.bfloat16, 128), (torch.bfloat16, 64),
                                      (torch.bfloat16, 256), (torch.float32, 128)])
@pytest.mark.parametrize("window", [0, 256])
def test_decode_kernel_matches_plain(cuda_device, dtype, hd, window):
    gen = torch.Generator().manual_seed(hd + window)
    t, h, kv = 4096, 32, 8
    lens = [1, 77, 2500, 4096]
    q = _rnd(gen, (len(lens), h, 1, hd), dtype, cuda_device)
    kc, vc = (_rnd(gen, (len(lens), kv, t, hd), dtype, cuda_device) for _ in range(2))
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    got = fd.flash_decode_attention(q, kc, vc, lengths, window=window)
    want = plain.decode_attention(q, kc, vc, lengths, window=window)
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.gpu
def test_decode_ticket_counters_return_to_zero(cuda_device):
    """Three back-to-back calls with different lengths (one row with no live
    key, one that fits one block, long rows that take many): the counters
    the last block of each (row, kv head) resets are 0 after every call."""
    gen = torch.Generator().manual_seed(7)
    t, h, kv, hd = 8192, 32, 8, 128
    q = _rnd(gen, (4, h, 1, hd), torch.bfloat16, cuda_device)
    kc, vc = (_rnd(gen, (4, kv, t, hd), torch.bfloat16, cuda_device) for _ in range(2))
    launches = fd.flash_decode_attention.launches
    for lens in ([0, 1, 4096, 8191], [8192, 8192, 8192, 8192], [5, 0, 64, 3000]):
        lengths = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
        got = fd.flash_decode_attention(q, kc, vc, lengths)
        want = plain.decode_attention(q, kc, vc, lengths)
        live = [i for i, n in enumerate(lens) if n > 0]
        assert (got[live].float() - want[live].float()).abs().max().item() <= 2e-2
        assert all(int(c.abs().sum()) == 0 for c in fd.ticket_counters()), lens
    assert fd.flash_decode_attention.launches == launches + 3
