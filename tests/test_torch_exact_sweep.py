"""The exact dense sweep's steps and its sweep runner, on the CPU.

``exact_sweep`` makes two steps per type position: ``commit_counts`` lands
the previous position's increments and this position's decrements on the
table and the topic totals, and ``draw_rows`` draws the live rows reading
the table in place.  On CPU tensors both take their plain versions; the
CUDA kernels are held to those on the card (tests/test_torch_cuda.py).
``ExactSweep`` repeats the sweep over one state; on the CPU it runs eagerly
and must draw the same stream as ``train_sweep_buckets``.
"""

import numpy as np
import pytest
import torch

from lda_thesis_tpu_torch.ops import draw_update_cuda as duc
from lda_thesis_tpu_torch.ops import gibbs as tgibbs

ALPHA, BETA = 0.1, 0.01
V, K = 30, 48


def _tok_f(seed, U, D, empty_positions=()):
    rng = np.random.default_rng(seed)
    f = rng.integers(0, 4, size=(U, D)).astype(np.float32)
    for p in empty_positions:
        f[p] = 0
    return torch.from_numpy(f)


def test_live_rows_lists_rows_with_f_in_order():
    tf = _tok_f(0, 7, 23, empty_positions=(2, 6))
    tv = torch.from_numpy(np.random.default_rng(1).integers(0, V, size=(7, 23)))
    live = tgibbs.live_rows(tv, tf)
    assert len(live) == 7
    for p, (rows, words) in enumerate(live):
        assert rows.dtype == torch.int32 and rows.is_contiguous()
        assert words.dtype == torch.int64 and words.is_contiguous()
        np.testing.assert_array_equal(rows.numpy(), np.nonzero(tf[p].numpy() > 0)[0])
        np.testing.assert_array_equal(words.numpy(), tv[p].numpy()[rows.numpy()])
    assert live[2][0].numel() == 0 and live[6][0].numel() == 0


def _slots(seed, D):
    rng = np.random.default_rng(seed)
    f = rng.integers(0, 4, size=D).astype(np.float32)
    rows = torch.from_numpy(rng.integers(0, V, size=D))
    z = torch.from_numpy(rng.integers(0, K, size=D).astype(np.int32))
    f = torch.from_numpy(f)
    return duc.Slots(rows, z, f, torch.nonzero(f > 0).flatten().to(torch.int32))


@pytest.mark.parametrize("parts", ["dec", "inc", "both", "neither"])
def test_commit_counts_adds_each_live_slot(parts):
    dec = _slots(1, 40) if parts in ("dec", "both") else None
    inc = _slots(2, 40) if parts in ("inc", "both") else None
    table = torch.from_numpy(np.random.default_rng(3).integers(5, 50, size=(V, K))
                             .astype(np.float32))
    n_k = table.sum(0)
    want_t, want_k = table.numpy().copy(), n_k.numpy().copy()
    for s, sign in ((dec, -1), (inc, 1)):
        if s is None:
            continue
        for d in s.live.tolist():
            want_t[s.rows[d], s.z[d]] += sign * s.f[d].item()
            want_k[s.z[d]] += sign * s.f[d].item()
    before = duc.commit_launches
    duc.commit_counts(table, n_k, dec, inc)
    assert duc.commit_launches == before  # the CPU takes the plain version
    np.testing.assert_array_equal(table.numpy(), want_t)
    np.testing.assert_array_equal(n_k.numpy(), want_k)
    assert torch.equal(n_k, table.sum(0))


def _draw_state(seed, D):
    rng = np.random.default_rng(seed)
    s = _slots(seed, D)
    labs = (rng.random((D, K)) < 0.3).astype(np.float32)
    labs[:, 0] = 1.0
    n_dk = rng.integers(0, 20, size=(D, K)).astype(np.float32)
    n_dk[np.arange(D), s.z.numpy()] += s.f.numpy()
    table = rng.integers(0, 300, size=(V, K)).astype(np.float32)
    u = rng.random(D).astype(np.float32)
    return s, *(torch.from_numpy(x) for x in (labs, n_dk, table, u))


def test_draw_rows_is_draw_update_on_the_live_rows():
    """The sweep's draw equals the op-level step on the gathered rows, with
    ``recip`` from the decremented totals, and leaves the other rows."""
    s, labs, n_dk, table, u = _draw_state(4, 50)
    n_k = table.sum(0)
    vbeta = V * BETA
    z = s.z.clone()
    got_ndk = n_dk.clone()
    duc.draw_rows(u, s.f, z, labs, got_ndk, table, s.rows[s.live.long()], n_k, s.live,
                  ALPHA, BETA, vbeta)
    want = duc.draw_update_torch(u, s.f, s.z.clone(), labs, n_dk.clone(), table[s.rows],
                                 1.0 / (n_k + vbeta), ALPHA, BETA)
    assert torch.equal(got_ndk, want[0]) and torch.equal(z, want[1])
    dead = s.f == 0
    assert torch.equal(z[dead], s.z[dead]) and torch.equal(got_ndk[dead], n_dk[dead])


def test_draw_rows_with_no_live_row_changes_nothing():
    s, labs, n_dk, table, u = _draw_state(5, 20)
    z, ndk = s.z.clone(), n_dk.clone()
    none = torch.zeros((0,), dtype=torch.int32)
    duc.draw_rows(u, s.f, z, labs, ndk, table, none.long(), table.sum(0), none, ALPHA, BETA,
                  0.3)
    assert torch.equal(z, s.z) and torch.equal(ndk, n_dk)


def test_sweep_steps_have_no_plain_fallback_off_cpu():
    """A tensor off the CPU goes to the kernel or raises."""
    s, labs, n_dk, table, u = _draw_state(6, 16)
    m = duc.Slots(*(t.to("meta") for t in s))
    table, n_k = table.to("meta"), table.sum(0).to("meta")
    with pytest.raises(ValueError, match="no kernel"):
        duc.commit_counts(table, n_k, m, None)
    with pytest.raises(ValueError, match="no kernel"):
        duc.draw_rows(u.to("meta"), m.f, m.z, labs.to("meta"), n_dk.to("meta"), table,
                      m.rows[:0], n_k, m.live[:0], ALPHA, BETA, 0.3)


def _buckets():
    """Three buckets sharing one table; the last two positions of bucket 1
    have no live row, as a bucket's U rounded up to a multiple of 8 can."""
    toks_v, toks_f, labs_t = [], [], []
    for g, (Dg, Ug) in enumerate([(20, 4), (30, 8), (1, 16)]):
        rng = np.random.default_rng(60 + g)
        toks_v.append(torch.from_numpy(rng.integers(0, V, size=(Dg, Ug))))
        tf = rng.integers(0, 4, size=(Dg, Ug))
        if g == 1:
            tf[:, -2:] = 0
        toks_f.append(torch.from_numpy(tf))
        lb = (rng.random((Dg, K)) < 0.2).astype(np.float32)
        lb[:, 0] = 1.0
        labs_t.append(torch.from_numpy(lb))
    return toks_v, toks_f, labs_t


def _runners(state, toks_v, toks_f, labs_t):
    z_t = [z.T.clone(memory_format=torch.contiguous_format) for z in state.z]
    n_dk = [x.clone() for x in state.n_dk]
    n_vk, n_k = state.n_vk.clone(), state.n_k.clone()
    runners = [tgibbs.ExactSweep(z_t[g], n_dk[g], n_vk, n_k, tv.T.contiguous(),
                                 tf.T.to(torch.float32).contiguous(), labs_t[g],
                                 ALPHA, BETA, V * BETA)
               for g, (tv, tf) in enumerate(zip(toks_v, toks_f))]
    return runners, z_t, n_dk, n_vk, n_k


def test_exact_sweep_runner_draws_the_train_sweep_stream():
    """Three sweeps of the runners, uniforms drawn into their static
    buffers, equal three ``train_sweep_buckets`` from the same generator
    state; on the CPU nothing is captured and no kernel is counted."""
    toks_v, toks_f, labs_t = _buckets()
    state = tgibbs.init_bucket_counts(toks_v, toks_f, labs_t, V,
                                      generator=torch.Generator().manual_seed(0))
    runners, z_t, n_dk, n_vk, n_k = _runners(state, toks_v, toks_f, labs_t)
    g_run = torch.Generator().manual_seed(11)
    g_ref = torch.Generator().manual_seed(11)
    before = (duc.launches, duc.commit_launches)
    ref = state
    for _ in range(3):
        for run in runners:
            run(g_run)
        ref = tgibbs.train_sweep_buckets(ref, toks_v, toks_f, labs_t, ALPHA, BETA,
                                         generator=g_ref)
    assert (duc.launches, duc.commit_launches) == before
    assert all(r._graph is None and r.sweeps == 3 for r in runners)
    for g in range(3):
        assert torch.equal(z_t[g].T, ref.z[g]) and torch.equal(n_dk[g], ref.n_dk[g])
    assert torch.equal(n_vk, ref.n_vk) and torch.equal(n_k, ref.n_k)
    assert torch.equal(n_k, n_vk.sum(0))


def test_exact_sweep_runner_takes_given_uniforms():
    toks_v, toks_f, labs_t = _buckets()
    state = tgibbs.init_bucket_counts(toks_v, toks_f, labs_t, V,
                                      generator=torch.Generator().manual_seed(1))
    runners, z_t, n_dk, n_vk, n_k = _runners(state, toks_v, toks_f, labs_t)
    gen = torch.Generator().manual_seed(3)
    us = [torch.rand(tuple(tv.T.shape), generator=gen) for tv in toks_v]
    for run, u in zip(runners, us):
        assert run(uniforms=u) is run.z_t
    ref = tgibbs.train_sweep_buckets(state, toks_v, toks_f, labs_t, ALPHA, BETA, uniforms=us)
    for g in range(3):
        assert torch.equal(z_t[g].T, ref.z[g]) and torch.equal(n_dk[g], ref.n_dk[g])
    assert torch.equal(n_vk, ref.n_vk) and torch.equal(n_k, ref.n_k)
