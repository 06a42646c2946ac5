"""The explicitly-batched engine must be step-for-step identical to the
vmapped per-lane engine."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from linprog_tpu import SolverConfig, engine
from linprog_tpu import status as st
from linprog_tpu.engine_batched import batched_primal_step, run_batched
from linprog_tpu.generators import random_inequality_lps, to_standard_form_batch


def _setup(B=6, m=8, n=10, seed=0):
    c, G, h = random_inequality_lps(B, m, n, seed=seed)
    cs, As, bs = to_standard_form_batch(c, G, h)
    csj = jnp.asarray(cs)
    Asj = jnp.asarray(As)
    bsj = jnp.asarray(bs)
    ntot = cs.shape[1]
    c1 = jnp.concatenate(
        [jnp.zeros((B, ntot), jnp.float32), jnp.ones((B, m), jnp.float32)], axis=1
    )
    eye = jnp.broadcast_to(jnp.eye(m, dtype=jnp.float32), (B, m, m))
    A1 = jnp.concatenate([Asj, eye], axis=2)
    states = jax.vmap(engine.artificial_state, in_axes=(0, None))(bsj, ntot)
    allowed = jnp.ones((ntot + m,), bool)
    return c1, A1, bsj, states, allowed


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("pricing", ["bland", "dantzig"])
def test_batched_step_matches_vmapped_step(seed, pricing):
    cfg = SolverConfig(pricing=pricing, dtype="float32")
    c1, A1, bsj, states, allowed = _setup(seed=seed)
    # several steps, comparing full state each time
    vstates = states
    bstates = states
    for step_i in range(12):
        vstates = jax.vmap(
            lambda cc, AA, bb, s: engine.primal_step(cc, AA, bb, allowed, s, cfg)
        )(c1, A1, bsj, vstates)
        bstates = batched_primal_step(c1, A1, bsj, allowed, bstates, cfg, 100)
        assert np.array_equal(np.asarray(vstates.basis), np.asarray(bstates.basis)), step_i
        assert np.array_equal(np.asarray(vstates.status), np.asarray(bstates.status))
        # float32 accumulation order differs between the batched and the
        # vmapped einsums; basis/status must match exactly, floats to ~1e-4
        np.testing.assert_allclose(
            np.asarray(vstates.bfs), np.asarray(bstates.bfs), atol=2e-4, rtol=2e-4
        )
        np.testing.assert_allclose(
            np.asarray(vstates.inv_B), np.asarray(bstates.inv_B), atol=2e-4, rtol=2e-4
        )


@pytest.mark.parametrize("pricing", ["bland", "dantzig", "devex"])
def test_run_batched_full_solve(pricing):
    cfg = SolverConfig(
        pricing=pricing, refactor_every=8, dtype="float32"
    )
    c1, A1, bsj, states, allowed = _setup(seed=3)
    out = run_batched(c1, A1, bsj, states, allowed, 200, cfg)
    status = np.asarray(out.status)
    assert (status == st.OPTIMAL).all()
    # phase-1 objective (sum of artificials) must reach ~0 for feasible LPs
    art = np.asarray(out.basis) >= (c1.shape[1] - bsj.shape[1])
    art_mass = np.where(art, np.asarray(out.bfs), 0.0).sum(axis=1)
    assert (art_mass < 1e-4).all()


def test_compact_refactorize_bit_exact():
    """Compacted (running-lanes-only) refactorization must be bit-exact vs
    the full-batch inversion on every running lane, for any runner count."""
    from linprog_tpu.engine_batched import compact_refactorize

    key = jax.random.PRNGKey(7)
    B, m, n = 64, 12, 30
    A = jax.random.normal(key, (B, m, n), jnp.float32)
    b = jax.random.normal(jax.random.PRNGKey(8), (B, m), jnp.float32)
    basis = (
        jnp.tile(jnp.arange(m, dtype=jnp.int32)[None], (B, 1))
        + (jnp.arange(B, dtype=jnp.int32) % 9)[:, None]
    )
    inv_f = jnp.linalg.inv(jnp.take_along_axis(A, basis[:, None, :], axis=2))
    bfs_f = jnp.einsum("bmk,bk->bm", inv_f, b)
    for p in (0.0, 0.15, 0.6, 1.0):
        run = jax.random.bernoulli(jax.random.PRNGKey(int(p * 100)), p, (B,))
        inv_c, bfs_c = jax.jit(compact_refactorize)(A, b, basis, run)
        r = np.asarray(run)
        assert np.array_equal(np.asarray(inv_c)[r], np.asarray(inv_f)[r])
        assert np.array_equal(np.asarray(bfs_c)[r], np.asarray(bfs_f)[r])


def test_newton_schulz_refactor_method():
    """`refactor_method="ns"` ran only in the removed Pallas drivers: the
    config rejects it instead of silently running exact inversion, and
    the remaining method ("inv") refactoring every 8 pivots reaches the
    same costs as one long segment."""
    with pytest.raises(ValueError, match="no longer supported"):
        SolverConfig(refactor_method="ns")
    with pytest.raises(ValueError, match="unknown refactor method"):
        SolverConfig(refactor_method="lu")
    c1, A1, bsj, states, allowed = _setup(seed=11)
    base = SolverConfig(pricing="dantzig", refactor_every=300)
    assert base.refactor_method == "inv"
    ref = run_batched(c1, A1, bsj, states, allowed, 300, base)
    c1b, A1b, bsjb, states2, _ = _setup(seed=11)
    out = run_batched(c1b, A1b, bsjb, states2, allowed, 300,
                      base.replace(refactor_every=8))
    assert (np.asarray(out.status) == st.OPTIMAL).all()
    cB_r = np.take_along_axis(np.asarray(c1), np.asarray(ref.basis), axis=1)
    cB_o = np.take_along_axis(np.asarray(c1), np.asarray(out.basis), axis=1)
    np.testing.assert_allclose(
        (cB_o * np.asarray(out.bfs)).sum(axis=1),
        (cB_r * np.asarray(ref.bfs)).sum(axis=1), rtol=5e-4, atol=5e-4,
    )
