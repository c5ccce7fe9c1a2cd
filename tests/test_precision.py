"""Every f32 dot product that the exact-integer premise rests on asks for
HIGHEST precision.

On a GPU an f32 matrix product at default precision may run in TF32, which
keeps 11 significant bits, so counts past 2^11 (int16-storage corpora) would
no longer multiply exactly; the double-single / certified decisions and the
bit-equal cross-device psums assume they do. These tests trace each program
and check the `precision` of every dot_general in it. The GPU tier checks
the arithmetic itself on the card.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

HIGHEST = jax.lax.Precision.HIGHEST


def _dot_precisions(jaxpr):
    """precision params of every dot_general in a jaxpr, sub-jaxprs too."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (list, tuple)) else [v]):
                if isinstance(sub, jax.extend.core.ClosedJaxpr):
                    out += _dot_precisions(sub.jaxpr)
                elif isinstance(sub, jax.extend.core.Jaxpr):
                    out += _dot_precisions(sub)
    return out


def _assert_highest(closed, at_least=1):
    precs = _dot_precisions(closed.jaxpr)
    assert len(precs) >= at_least, precs
    for p in precs:
        assert p == (HIGHEST, HIGHEST), p


def test_pair_sums_dot_is_highest():
    from meshclust_tpu.ops import features as F
    h = jnp.ones((4, 16), jnp.int16)
    _assert_highest(jax.make_jaxpr(F.pair_sums_device)(h, h))


def test_classify_window_dot_is_highest():
    import __graft_entry__ as g
    fn, args = g.entry()
    _assert_highest(jax.make_jaxpr(fn)(*args))


def test_accumulate_dots_are_highest(rng, monkeypatch):
    """Phase A's dist/dot sweep and member-sum matvec (the program
    accumulate_device actually builds and runs)."""
    from meshclust_tpu.core import accumulate_device as ACC
    from tests.test_accum_device import _fresh_bv, _params, _pointset
    traced = []
    build = ACC.build_accumulate

    def recording_build(*a, **k):
        fn = build(*a, **k)

        def run(*args):
            if not traced:
                traced.append(jax.make_jaxpr(fn)(*args))
            return fn(*args)
        return run

    monkeypatch.setattr(ACC, "build_accumulate", recording_build)
    ps = _pointset(rng, n_species=3, per=4, length=200)
    ACC.accumulate_device(ps, _fresh_bv(ps), _params(ps), sim=0.90)
    _assert_highest(traced[0], at_least=2)


def test_mesh_update_step_dot_is_highest(rng):
    from tests.test_parallel import _problem
    from jax.sharding import Mesh
    from meshclust_tpu.parallel import mesh as M
    hist, mag, sq, lens, assign, gid, c_rows, prm = _problem(rng, Mn=16)
    mesh = Mesh(np.array(jax.devices()[:1]), axis_names=("data",))
    singles, combos = M.default_combo_structure()
    step = M.make_update_step(mesh, V=hist.shape[1], delta=1,
                              singles=singles, combos=combos)
    args = (hist, mag, sq, lens, assign, gid, hist[c_rows], mag[c_rows],
            sq[c_rows], lens[c_rows], prm)
    _assert_highest(jax.make_jaxpr(step)(*args))


@pytest.mark.parametrize("env", [None, "custom"])
def test_compile_cache_path_rule(monkeypatch, tmp_path, env):
    """The cache lands in $JAX_COMPILATION_CACHE_DIR when it is set (and no
    other directory is set in code), else in .jax_cache at the root of the
    checkout."""
    from meshclust_tpu.utils import jaxcache
    before = jax.config.jax_compilation_cache_dir
    try:
        jax.config.update("jax_compilation_cache_dir", None)
        if env:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
            jaxcache.enable()
            assert jaxcache.cache_dir() == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir is None
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            jaxcache.enable()
            root = jaxcache.REPO_CACHE.parent
            assert (root / "meshclust_tpu").is_dir()
            assert jaxcache.REPO_CACHE.name == ".jax_cache"
            assert jax.config.jax_compilation_cache_dir == str(
                jaxcache.REPO_CACHE)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
