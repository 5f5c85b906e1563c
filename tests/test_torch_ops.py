"""Each torch op of the port's step agrees with its JAX twin bit for bit on
seeded inputs.

Two comparisons per op. Evaluated op by op (``jax.disable_jit``), the JAX
op and the torch op round the same IEEE operations in the same order, and
must agree on every bit. Under ``jax.jit`` — as inside the reference's
scan — XLA's CPU backend rewrites two of them: its algebraic simplifier
folds a constant weight into a constant scale (``w * (s * 50)`` becomes
``s * (w * 50)``), and LLVM contracts a multiply feeding an add into one
FMA (XLA's CPU target allows FP op fusion). That moves
``resource_scores_fused`` and the reversed ``max_apply`` by one ulp at
some inputs. The tests prove that this is the only difference: the jitted
JAX result equals, bit for bit, the rewritten form evaluated with a true
FMA (``xla_fma`` below). The port keeps the unrewritten form — the kernel
on the card is built without contraction and held bit for bit against
it — and the engine tests stay exact on every config."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_simulator_tpu.ops import domains as jdom
from open_simulator_tpu.ops import filters as jfil
from open_simulator_tpu.ops import scores as jsc
from open_simulator_tpu_torch.ops import domains as tdom
from open_simulator_tpu_torch.ops import filters as tfil
from open_simulator_tpu_torch.ops import scores as tsc

N, R = 97, 4


def bits(x) -> np.ndarray:
    a = np.asarray(x)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def same(j, t):
    j = np.asarray(j)
    t = t.numpy()
    assert j.dtype == t.dtype and j.shape == t.shape
    np.testing.assert_array_equal(bits(j), bits(t))


def f32(a):
    return np.asarray(a, dtype=np.float32)


def xla_fma(a, b, c):
    """f32 fused multiply-add: the f32 product is exact in f64, and the
    f64 sum rounds once more to f32 (a double rounding that could differ
    from a true FMA only if the f64 sum fell exactly on an f32 tie; the
    seeded inputs here do not)."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def eager(fn, *args):
    with jax.disable_jit():
        return fn(*args)


def seeded(seed):
    rng = np.random.RandomState(seed)
    alloc = f32(rng.randint(0, 64000, size=(N, R)))
    alloc[rng.rand(N, R) < 0.1] = 0.0
    headroom = f32(alloc - rng.randint(0, 40000, size=(N, R)))
    req = f32(rng.randint(0, 4000, size=R))
    req[rng.randint(R)] = 0.0
    inv = np.where(alloc > 0, np.float32(1.0) / np.where(alloc > 0, alloc, np.float32(1)),
                   np.float32(0)).astype(np.float32)
    return rng, alloc, headroom, req, inv


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_filters(seed):
    rng, alloc, headroom, req, inv = seeded(seed)
    t = tfil.fit_per_resource(torch.from_numpy(headroom), torch.from_numpy(req))
    same(eager(jfil.fit_per_resource, headroom, req), t)
    same(jax.jit(jfil.fit_per_resource)(headroom, req), t)
    used = rng.rand(N, 5) < 0.3
    pod = rng.rand(5) < 0.4
    t = tfil.ports_free(torch.from_numpy(used), torch.from_numpy(pod))
    same(eager(jfil.ports_free, used, pod), t)
    same(jax.jit(jfil.ports_free)(used, pod), t)


def xla_resource_scores(headroom, inv, req, wb, wl, wm):
    """resource_scores_fused as XLA's CPU backend computes it under jit:
    constant weights folded into the constant scales, and each
    ``out + s * c`` contracted into fma(s, c, out)."""
    hc = (headroom[:, 0] - req[0]) * inv[:, 0]
    hm = (headroom[:, 1] - req[1]) * inv[:, 1]
    out = np.zeros(N, np.float32)
    if wb:
        out = (np.float32(1.0) - np.abs(hc - hm) * np.float32(0.5)) * np.float32(wb * 100.0)
    if wl:
        s = np.maximum(hc, np.float32(0)) + np.maximum(hm, np.float32(0))
        out = xla_fma(s, np.float32(wl * 50.0), out)
    if wm:
        s = (np.clip(np.float32(1) - hc, 0, 1) * (inv[:, 0] > 0)
             + np.clip(np.float32(1) - hm, 0, 1) * (inv[:, 1] > 0)).astype(np.float32)
        out = xla_fma(s, np.float32(wm * 50.0), out)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("weights", [(1.0, 1.0, 0.0), (1.0, 1.0, 1.0), (0.5, 2.0, 3.0),
                                     (0.0, 1.0, 0.0)])
def test_resource_scores_fused(seed, weights):
    _, alloc, headroom, req, inv = seeded(seed)
    wb, wl, wm = weights

    def jfn(h, i, r):
        return jsc.resource_scores_fused(h, i, r, (0, 1), wb, wl, wm)

    t = tsc.resource_scores_fused(torch.from_numpy(headroom), torch.from_numpy(inv),
                                  torch.from_numpy(req), (0, 1), wb, wl, wm)
    same(eager(jfn, headroom, inv, req), t)
    np.testing.assert_array_equal(bits(jax.jit(jfn)(headroom, inv, req)),
                                  bits(xla_resource_scores(headroom, inv, req, wb, wl, wm)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_simon_max_share_raw(seed):
    _, alloc, _, req, _ = seeded(seed)
    alloc[:3] = req  # avail == 0 rows
    t = tsc.simon_max_share_raw(torch.from_numpy(alloc), torch.from_numpy(req))
    same(eager(jsc.simon_max_share_raw, alloc, req), t)
    same(jax.jit(jsc.simon_max_share_raw)(alloc, req), t)


def _lohi(rng):
    raw = f32(rng.rand(N) * 300.0)
    cases = [(raw.min(), raw.max()), (f32(5.0), f32(5.0)), (f32(3.4e38), f32(-3.4e38)),
             (f32(0.0), f32(0.0)), (raw.min(), f32(0.0))]
    return raw, cases


@pytest.mark.parametrize("seed", [0, 1])
def test_minmax_and_max_apply(seed):
    rng = np.random.RandomState(seed)
    raw, cases = _lohi(rng)
    traw = torch.from_numpy(raw)
    for lo, hi in cases:
        lo, hi = f32(lo), f32(hi)
        tlo, thi = torch.tensor(lo), torch.tensor(hi)
        t = tsc.minmax_apply(traw, tlo, thi)
        same(eager(jsc.minmax_apply, raw, lo, hi), t)
        same(jax.jit(jsc.minmax_apply)(raw, lo, hi), t)
        for rev in (False, True):
            def jfn(r, h):
                return jsc.max_apply(r, h, reverse=rev)

            t = tsc.max_apply(traw, thi, reverse=rev)
            same(eager(jfn, raw, hi), t)
            inv = np.float32(100.0) / hi if hi > 0 else np.float32(0.0)
            # jitted, 100 - raw * inv is contracted into one FMA
            want = xla_fma(-raw, inv, np.float32(100.0)) if rev else raw * inv
            np.testing.assert_array_equal(bits(jax.jit(jfn)(raw, hi)), bits(want))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("any_soft", [False, True])
def test_spread_apply(seed, any_soft):
    """base + (c1 - raw) * inv: contraction cannot move it (base is 0
    wherever inv is not), so the jitted result is exact too."""
    rng = np.random.RandomState(seed)
    raw, cases = _lohi(rng)
    node_ok = rng.rand(N) < 0.8
    for lo, hi in cases:
        lo, hi = f32(lo), f32(hi)
        t = tsc.spread_apply(torch.from_numpy(raw), torch.tensor(lo), torch.tensor(hi),
                             torch.from_numpy(node_ok), any_soft)
        args = (raw, lo, hi, node_ok, jnp.asarray(any_soft))
        same(eager(jsc.spread_apply, *args), t)
        same(jax.jit(jsc.spread_apply)(*args), t)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_hoist_log_dom(seed):
    """log_dom = log(#active domains + 2) per key, equal to the reference's
    on its own: a one-ulp difference in the spread weight flips ties."""
    rng = np.random.RandomState(seed)
    n, k1, d = 64, 2, 7
    dom = rng.randint(-1, d, size=(k1, n))
    topo = np.zeros((k1, n, d), np.float32)
    for k in range(k1):
        for i in range(n):
            if dom[k, i] >= 0:
                topo[k, i, dom[k, i]] = 1.0
    has_key = np.concatenate([np.ones((1, n), np.float32), (dom >= 0).astype(np.float32)])
    cls = rng.rand(3, n) < 0.9
    active = rng.rand(n) < (0.3 + 0.2 * seed)
    ht = tdom.hoist_active_stats(torch.from_numpy(topo), torch.from_numpy(has_key),
                                 torch.from_numpy(cls), torch.from_numpy(active))
    for hj in (eager(jdom.hoist_active_stats, topo, has_key, cls, active),
               jax.jit(jdom.hoist_active_stats)(topo, has_key, cls, active)):
        same(hj.dom_counts, ht.dom_counts)
        same(hj.log_dom, ht.log_dom)


def test_log_f32_matches_reference_log_over_counts():
    """Every domain count up to 2^16 (x = count + 2), and seeded reals."""
    x = np.concatenate([np.arange(2, 65538, dtype=np.float32),
                        np.random.RandomState(0).uniform(1.0, 1e7, 4096).astype(np.float32)])
    np.testing.assert_array_equal(bits(jax.jit(jnp.log)(x)), bits(tdom.log_f32(x)))
    # a correctly rounded log differs at 7: the reason log_f32 exists
    assert np.float32(np.log(np.float64(7.0))) != np.asarray(jnp.log(np.float32(7.0)))
