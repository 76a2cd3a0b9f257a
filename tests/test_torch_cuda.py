"""Card-only checks of the port's CUDA kernels, with no JAX import.

Each test is marked ``cuda`` and skips without a CUDA device.  The file
imports nothing of JAX, so it also runs where JAX is not installed:

    LDA_TESTS_KEEP_PLATFORM=1 python -m pytest -m cuda tests/test_torch_cuda.py

(``LDA_TESTS_KEEP_PLATFORM=1`` keeps tests/conftest.py from importing JAX.)
"""

import numpy as np
import pytest
import torch

import chip_smoke
from lda_thesis_tpu_torch.ops import draw_update_cuda as duc
from lda_thesis_tpu_torch.ops import fused_block_cuda as fbc
from lda_thesis_tpu_torch.ops import gibbs as tgibbs

ALPHA, BETA = 0.1, 0.01


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these checks on the card")


def _step_inputs(seed, D, K):
    """One exact-sweep position: a third of f = 0 and one all-zero label row."""
    rng = np.random.default_rng(seed)
    labs = (rng.random((D, K)) < 0.3).astype(np.float32)
    labs[:, 0] = 1.0
    f = rng.integers(1, 4, size=D).astype(np.float32)
    f[rng.random(D) < 0.33] = 0.0
    labs[1], f[1] = 0.0, 0.0
    z_old = (rng.random(D) * K).astype(np.int32)
    n_dk = rng.integers(0, 20, size=(D, K)).astype(np.float32)
    n_dk[np.arange(D), z_old] += f
    cv = rng.integers(0, 300, size=(D, K)).astype(np.float32)
    recip = (1.0 / (rng.integers(1000, 9000, size=K) + 89.69)).astype(np.float32)
    u = rng.random(D).astype(np.float32)
    return [torch.from_numpy(x).cuda() for x in (u, f, z_old, labs, n_dk, cv, recip)]


def _same_bits(a, b):
    return a.dtype == b.dtype and torch.equal(a.contiguous().view(torch.int32),
                                              b.contiguous().view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 128), (37, 40), (300, 512), (9, 7), (1000, 371)],
                         ids=lambda s: f"D{s[0]}-K{s[1]}")
def test_draw_update_kernel_matches_plain_version(shape):
    _needs_card()
    args = _step_inputs(sum(shape), *shape)
    before = duc.launches
    got = duc.draw_update(*[t.clone() for t in args], ALPHA, BETA)
    want = duc.draw_update_torch(*[t.clone() for t in args], ALPHA, BETA)
    torch.cuda.synchronize()
    assert duc.launches == before + 1
    assert all(_same_bits(g, w) for g, w in zip(got, want))
    assert int(got[1][1]) == int(args[2][1])  # the all-zero row keeps its topic


@pytest.mark.cuda
def test_exact_sweep_on_card_matches_cpu():
    _needs_card()
    rng = np.random.default_rng(0)
    D, U, K, V = 200, 12, 128, 50
    tok_v = torch.from_numpy(rng.integers(0, V, size=(D, U)))
    tok_v[:, 3] = 7  # every document has word 7 at position 3
    tok_f = torch.from_numpy(rng.integers(0, 4, size=(D, U)))
    labs = torch.from_numpy((rng.random((D, K)) < 0.1).astype(np.float32))
    labs[:, 0] = 1.0
    g = torch.Generator().manual_seed(1)
    c = tgibbs.init_counts(tok_v, tok_f, labs, V, generator=g)
    u = torch.rand((U, D), generator=g)
    before = duc.launches
    on_card = tgibbs.train_sweep(tgibbs.LDACounts(*(t.cuda() for t in c)), tok_v.cuda(),
                                 tok_f.cuda(), labs.cuda(), ALPHA, BETA, uniforms=u.cuda())
    on_cpu = tgibbs.train_sweep(c, tok_v, tok_f, labs, ALPHA, BETA, uniforms=u)
    torch.cuda.synchronize()
    assert duc.launches == before + U
    assert all(_same_bits(a.cpu(), b) for a, b in zip(on_card, on_cpu))
    assert torch.equal(on_card.n_k, on_card.n_vk.sum(0))


# ---- the merge-block kernel (fused_block.cu) against fused_block_torch


def _check_block(args):
    before = fbc.launches
    got = fbc.fused_block(*args, ALPHA, BETA)
    want = fbc.fused_block_torch(*args, ALPHA, BETA)
    torch.cuda.synchronize()
    assert fbc.launches == before + 1
    assert all(_same_bits(g, w) for g, w in zip(got, want))
    return got


# (D, U, A, M, gaps, zero_doc): the main path's four buckets (depth-3
# abstracts, A = 24, M = 25), then chip_smoke.py's edge cases: ragged
# shapes, two waves of CTAs, one and 32 slots, a document with no live
# position, interior gaps, U = 512, and documents of one or two positions
# (with one, each step's next step is the same position)
BLOCK_CASES = {
    "bucket0": (1653, 32, 24, 25, 0.0, False),
    "bucket1": (1148, 48, 24, 25, 0.0, False),
    "bucket2": (955, 80, 24, 25, 0.0, False),
    "bucket3": (415, 128, 24, 25, 0.0, False),
    **chip_smoke.edge_cases(),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_fused_block_kernel_matches_plain_version(case):
    _needs_card()
    D, U, A, M, gaps, zero_doc = BLOCK_CASES[case]
    args = chip_smoke.block_case("cuda", D + U + A, D, U, A, M, gaps, zero_doc)
    z, ndk = _check_block(args)
    if zero_doc:  # no live position: z and n_dk come back as they went in
        assert torch.equal(z[:, 0], args[3][:, 0])
        assert _same_bits(ndk[:, 0], args[6][:, 0])


@pytest.mark.cuda
def test_fused_block_shared_memory_layout_and_limit():
    """The kernel runs at the widest document its shared memory holds and
    the wrapper raises one position past it; at A = 32 that is at least
    the 512 positions the port's models may give it."""
    _needs_card()
    U = fbc.max_positions(32)
    assert U >= 512
    _check_block(chip_smoke.block_case("cuda", 1, 4, U, 32, 1))
    args = chip_smoke.block_case("cuda", 1, 4, U + 1, 32, 1)
    with pytest.raises(ValueError, match=f"at most {U} positions at A=32"):
        fbc.fused_block(*args, ALPHA, BETA)
    with pytest.raises(ValueError, match="slots"):
        fbc.max_positions(33)
