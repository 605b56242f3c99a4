"""Port parity: the trainers' optimizer (``lsd_tpu_torch/training/optim.py``)
against the reference's optax chain

    optax.chain(optax.clip_by_global_norm(c),
                optax.adamw(optax.warmup_cosine_decay_schedule(
                    0.0, lr, warmup, max(total, warmup + 1)), weight_decay=wd))

on the same random gradients (numpy, from a seed), 300 steps, with the
clip biting on some steps and never.  The schedule runs 20 warmup steps
(the first update has lr 0 while the moments advance), decays to 0 at step
250 and stays there for the last 50 (the parameters must then hold still).

Tolerances: the schedule within 1e-6 of optax's value, relative, or 1e-7 of
the peak near the end of the cosine, where ``1 + cos`` cancels (both in
float32, ``cos`` from different libraries; measured 1.4e-6 relative at
3e-7 of the peak); after every step
each parameter within 1e-5 of its leaf's largest magnitude, and the moments
within 1e-5 of theirs (the sums round in another order; ``add`` with
``alpha`` may fuse its multiply, and a card divides by a scalar through its
reciprocal).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lsd_tpu_torch.training.optim import ClippedAdamW, warmup_cosine_decay

SHAPES = {"conv": (8, 4, 3, 3), "bias": (8,), "scale": (8,), "dense": (16, 5)}
LR, WARMUP, TOTAL, WD, STEPS = 3e-2, 20, 250, 1e-2, 300
REL = 1e-5


@pytest.mark.parametrize("warmup,total", [(20, 250), (100, 1000), (0, 40), (5, 5), (100, 50)])
def test_schedule_matches_optax(warmup, total):
    sched = optax.warmup_cosine_decay_schedule(0.0, LR, warmup, max(total, warmup + 1))
    decay = max(total, warmup + 1)
    counts = np.arange(decay + 30)
    want = np.asarray(jax.vmap(sched)(jnp.asarray(counts, jnp.int32)))
    got = np.asarray([warmup_cosine_decay(int(c), LR, warmup, decay) for c in counts], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7 * LR)
    if warmup:
        assert got[0] == 0.0
    assert got[-1] == 0.0 and np.all(got[decay:] == 0.0)


def _close(got, want, what):
    for k, w in want.items():
        g = got[k].detach().numpy()
        err = float(np.abs(g - w).max()) / max(float(np.abs(w).max()), 1e-12)
        assert err <= REL, (what, k, err)


@pytest.mark.parametrize("clip", [0.5, 1e9], ids=["clip_on", "clip_off"])
def test_matches_optax_over_300_steps(clip):
    rng = np.random.default_rng(0)
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    tx = optax.chain(optax.clip_by_global_norm(clip),
                     optax.adamw(optax.warmup_cosine_decay_schedule(
                         0.0, LR, WARMUP, max(TOTAL, WARMUP + 1)), weight_decay=WD))
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)

    @jax.jit
    def step(p, s, g):
        u, s = tx.update(g, s, p)
        return optax.apply_updates(p, u), s

    tp = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in params.items()}
    opt = ClippedAdamW(tp.items(), LR, WARMUP, TOTAL, WD, clip)
    clipped = 0
    for i in range(STEPS):
        # scales spread over three orders of magnitude: the clip bites on some steps
        scale = 10.0 ** rng.uniform(-2.5, 0.5)
        grads = {k: (scale * rng.normal(size=s)).astype(np.float32) for k, s in SHAPES.items()}
        clipped += np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                               for g in grads.values())) >= clip
        jp, state = step(jp, state, jax.tree.map(jnp.asarray, grads))
        for k, p in tp.items():
            p.grad = torch.tensor(grads[k])
        opt.step()
        opt.zero_grad()
        want = jax.device_get(jp)
        _close(tp, want, f"params after step {i + 1}")
        if i == 0:
            np.testing.assert_array_equal(tp["conv"].detach().numpy(), params["conv"])
        if i + 1 == TOTAL:
            held = {k: p.detach().clone() for k, p in tp.items()}
    adam = state[1][0]
    sd = opt.state_dict()
    assert sd["count"] == int(adam.count) == STEPS == sd["schedule_count"] == int(state[1][2].count)
    _close(sd["mu"], jax.device_get(adam.mu), "mu")
    _close(sd["nu"], jax.device_get(adam.nu), "nu")
    if clip < 1:
        assert 50 < clipped < STEPS - 50
    else:
        assert clipped == 0
    # the schedule is at 0 for the last 50 steps: the parameters hold still
    assert warmup_cosine_decay(TOTAL, LR, WARMUP, TOTAL) == 0.0
    for k, p in tp.items():
        assert torch.equal(p.detach(), held[k]), k


def test_state_dict_round_trip_resumes():
    rng = np.random.default_rng(1)
    make = lambda: {k: torch.nn.Parameter(torch.tensor(rng.normal(size=s).astype(np.float32)))
                    for k, s in SHAPES.items()}
    a = make()
    b = {k: torch.nn.Parameter(v.detach().clone()) for k, v in a.items()}
    oa = ClippedAdamW(a.items(), LR, WARMUP, TOTAL, WD, 1.0)
    grads = [{k: torch.tensor(rng.normal(size=s).astype(np.float32)) for k, s in SHAPES.items()}
             for _ in range(8)]

    def run(params, opt, gs):
        for g in gs:
            for k, p in params.items():
                p.grad = g[k].clone()
            opt.step()
            opt.zero_grad()
    run(a, oa, grads[:5])
    ob = ClippedAdamW(b.items(), LR, WARMUP, TOTAL, WD, 1.0)
    with torch.no_grad():
        for k in b:
            b[k].copy_(a[k])
    ob.load_state_dict(oa.state_dict())
    run(a, oa, grads[5:])
    run(b, ob, grads[5:])
    for k in a:
        assert torch.equal(a[k], b[k]), k
    with pytest.raises(ValueError, match="does not fit"):
        ob.load_state_dict(dict(oa.state_dict(), mu={}))
