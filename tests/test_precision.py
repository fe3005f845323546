"""Every float32 matmul on the pixel path carries an explicit precision.

On the GPU a float32 dot at DEFAULT precision may run in TF32, so each
call site names the precision PERF.md's measurement chose; these tests
read it back from the traced program (jax.make_jaxpr)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from picha_tpu.ops import jpeg_fused, jpeg_tpu, resize


def _dot_precisions(fn, *args):
    """Precision configs of every dot_general in fn's jaxpr, nested
    jaxprs included."""
    out = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                out.append(eqn.params["precision"])
            for v in eqn.params.values():
                if hasattr(v, "jaxpr"):
                    walk(v.jaxpr)
                elif hasattr(v, "eqns"):
                    walk(v)

    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return out


def _expected(name):
    p = jax.lax.Precision(name)
    return (p, p)


def _idct():
    c = jnp.zeros((1, 2, 2, 64), jnp.int16)
    q = jnp.ones((1, 1, 1, 64), jnp.uint16)
    return (lambda c, q: jpeg_tpu.dequant_idct_plane(c, q, 16, 16)), (c, q)


def _fdct():
    b = jnp.zeros((1, 2, 2, 64), jnp.int32)
    q = jnp.ones((64,), jnp.uint16)
    return jpeg_tpu.fdct_quant, (b, q)


def _fused():
    c = jnp.zeros((1, 2, 2, 64), jnp.int16)
    q = jnp.ones((1, 1, 1, 64), jnp.uint16)
    geom = (8, 8, 16, 16, 16, 16, 1, 1, "cubic", 1.0)
    return (lambda c, q: jpeg_fused.fused_component(c, q, geom)), (c, q)


def _resize_dense():
    x = jnp.zeros((1, 32, 32, 3), jnp.float32)
    return (lambda x: resize.resize_f32(x, 16, 16, "cubic", 1.0)), (x,)


def _resize_banded():
    n = resize.BANDED_THRESHOLD + 64
    x = jnp.zeros((n, 8, 1), jnp.float32)
    return (lambda x: resize._apply_axis(x, n // 2, n, "cubic", 1.0,
                                         axis=-3)), (x,)


@pytest.mark.parametrize("site,const", [
    (_idct, (jpeg_tpu, "DCT_PRECISION")),
    (_fdct, (jpeg_tpu, "DCT_PRECISION")),
    (_fused, (jpeg_fused, "FOLD_PRECISION")),
    (_resize_dense, (resize, "RESIZE_PRECISION")),
    (_resize_banded, (resize, "RESIZE_PRECISION")),
], ids=["idct", "fdct", "fused_fold", "resize_dense", "resize_banded"])
def test_pixel_matmuls_carry_their_precision(site, const):
    fn, args = site()
    precs = _dot_precisions(fn, *args)
    assert precs, "no matmul traced"
    want = _expected(getattr(*const))
    assert all(p == want for p in precs), precs


def test_sharded_resize_carries_resize_precision():
    from picha_tpu.parallel.mesh import make_mesh
    from picha_tpu.parallel.spatial import _build

    mesh = make_mesh((("sp", 2),), devices=jax.devices()[:2])
    fn = _build(32, 16, 3, 16, 8, "cubic", 1.0, 2, "sp", mesh)
    precs = _dot_precisions(fn, jnp.zeros((32, 16, 3), jnp.uint8))
    want = _expected(resize.RESIZE_PRECISION)
    assert precs and all(p == want for p in precs), precs


def test_pinned_precision_keeps_cpu_numerics():
    """The pins change nothing on the CPU backend: the IDCT of a DC-only
    block is still the flat level-shifted value."""
    c = np.zeros((1, 1, 1, 64), np.int16)
    c[..., 0] = 80  # DC 80 * q 1 -> +10 after the 1/8 DCT scale
    q = np.ones((1, 1, 1, 64), np.uint16)
    out = np.asarray(jpeg_tpu.dequant_idct_plane(jnp.asarray(c),
                                                 jnp.asarray(q), 8, 8))
    assert (out == 138).all()
