"""Op-level tests: ``vitax.ops`` against float64 NumPy references.

The references below share no code with ``vitax.ops``. Forward outputs are
compared directly; gradients either against the analytic attention
backward in NumPy or, for the whole blocks, as directional derivatives
against central finite differences of the NumPy forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vitax import ops
from vitax.ops import extract_patches, patchify, spt_shifts, unpatchify
from vitax.ops.attention_core import uses_cudnn


def rand(key, shape, dtype=jnp.float32):
    return jax.random.normal(jax.random.PRNGKey(key), shape, dtype=dtype)


def f64(x):
    return np.asarray(x, np.float64)


# --------------------------------------------------------------------------
# float64 NumPy references


def np_softmax(s):
    e = np.exp(s - s.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def np_attention_probs(q, k, bias=None, scale=None, mask_self=False):
    q, k = f64(q), f64(k)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    s = np.einsum("bhid,bhjd->bhij", q, k) * scale
    if bias is not None:
        s = s + f64(bias)
    if mask_self:
        nq, nk = s.shape[-2:]
        s = np.where(np.eye(nq, nk, dtype=bool), -1e300, s)
    return np_softmax(s)


def np_attention(q, k, v, bias=None, scale=None, mask_self=False):
    p = np_attention_probs(q, k, bias, scale, mask_self)
    return np.einsum("bhij,bhjd->bhid", p, f64(v))


def np_attention_grads(q, k, v, bias, g, scale=None, mask_self=False):
    """Analytic backward of ``np_attention`` for the cotangent ``g``:
    dV = P^T g; dP = g V^T; dS = P * (dP - rowsum(g * O)); dQ = scale dS K;
    dK = scale dS^T Q; dbias = dS summed over the bias's broadcast axes."""
    q, k, v, g = f64(q), f64(k), f64(v), f64(g)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    p = np_attention_probs(q, k, bias, scale, mask_self)
    o = np.einsum("bhij,bhjd->bhid", p, v)
    dv = np.einsum("bhij,bhid->bhjd", p, g)
    dp = np.einsum("bhid,bhjd->bhij", g, v)
    ds = p * (dp - np.sum(g * o, axis=-1, keepdims=True))
    dq = scale * np.einsum("bhij,bhjd->bhid", ds, k)
    dk = scale * np.einsum("bhij,bhid->bhjd", ds, q)
    db = None
    if bias is not None:
        db = ds
        for ax in (0, 1):
            if bias.shape[ax] == 1:
                db = db.sum(axis=ax, keepdims=True)
    return dq, dk, dv, db


def np_layer_norm(x, scale, bias, eps):
    x = f64(x)
    mean = x.mean(-1, keepdims=True)
    var = ((x - mean) ** 2).mean(-1, keepdims=True)
    out = (x - mean) / np.sqrt(var + eps) * f64(scale)
    return out if bias is None else out + f64(bias)


def np_act(h, activation):
    if activation == "gelu":
        return 0.5 * h * (1.0 + np.tanh(np.sqrt(2.0 / np.pi) * (h + 0.044715 * h**3)))
    if activation == "hard_swish":
        return h * np.clip(h + 3.0, 0.0, 6.0) / 6.0
    raise ValueError(activation)


def np_mlp(x, w1, b1, w2, b2, ln_s=None, ln_b=None, activation="gelu",
           residual=True, eps=1e-6):
    h = f64(x) if ln_s is None else np_layer_norm(x, ln_s, ln_b, eps)
    h = h @ f64(w1) + (0 if b1 is None else f64(b1))
    h = np_act(h, activation) @ f64(w2) + (0 if b2 is None else f64(b2))
    return h + f64(x) if residual else h


def np_heads(x, ln_s, ln_b, wqkv, heads, eps):
    b, n, _ = x.shape
    d = wqkv.shape[1] // 3 // heads
    qkv = np_layer_norm(x, ln_s, ln_b, eps) @ f64(wqkv)
    return qkv.reshape(b, n, 3, heads, d).transpose(2, 0, 3, 1, 4)


def np_merge(o):
    b, h, n, d = o.shape
    return o.transpose(0, 2, 1, 3).reshape(b, n, h * d)


def np_block(x, ln_s, ln_b, wqkv, wout, bout, heads, eps=1e-6):
    """Pre-norm self-attention block with the residual add."""
    q, k, v = np_heads(x, ln_s, ln_b, wqkv, heads, eps)
    o = np_merge(np_attention(q, k, v))
    return f64(x) + o @ f64(wout) + f64(bout)


def np_window_block(xw, ln_s, ln_b, wqkv, wout, bout, heads, bias=None, eps=1e-5):
    q, k, v = np_heads(xw, ln_s, ln_b, wqkv, heads, eps)
    s = xw.shape[1]
    bb = None if bias is None else f64(bias).reshape(1, -1, s, s)
    o = np_merge(np_attention(q, k, v, bb))
    return o @ f64(wout) + f64(bout)


def np_reattention_block(x, ln_s, ln_b, wqkv, wout, bout, mix, rs, rb, heads, eps=1e-6):
    q, k, v = np_heads(x, ln_s, ln_b, wqkv, heads, eps)
    p = np_attention_probs(q, k)
    r = np.einsum("bhij,hg->bgij", p, f64(mix))
    r = np_layer_norm(r.transpose(0, 2, 3, 1), rs, rb, 1e-6).transpose(0, 3, 1, 2)
    o = np_merge(np.einsum("bhij,bhjd->bhid", r, v))
    return f64(x) + o @ f64(wout) + f64(bout)


def np_talking_heads_block(x, ln_s, ln_b, wqkv, wout, bout, mix_pre, mix_post,
                           heads, residual=False, eps=1e-5):
    q, k, v = np_heads(x, ln_s, ln_b, wqkv, heads, eps)
    s = np.einsum("bhid,bhjd->bhij", q, k) * q.shape[-1] ** -0.5
    s = np.einsum("bhij,hg->bgij", s, f64(mix_pre))
    p = np.einsum("bhij,hg->bgij", np_softmax(s), f64(mix_post))
    o = np_merge(np.einsum("bhij,bhjd->bhid", p, v))
    out = o @ f64(wout) + f64(bout)
    return out + f64(x) if residual else out


def directional_check(jax_fn, np_fn, args, *, seed=0, eps=1e-5, rtol=2e-3):
    """<grad of sum(jax_fn(args)**2), u> against the central difference of
    the float64 NumPy ``np_fn`` along a random direction ``u``."""
    loss = lambda *a: jnp.sum(jax_fn(*a) ** 2)
    grads = jax.grad(loss, argnums=tuple(range(len(args))))(*args)
    rng = np.random.default_rng(seed)
    us = [rng.normal(size=np.shape(a)) for a in args]
    analytic = sum(float(np.sum(f64(g) * u)) for g, u in zip(grads, us))
    np_loss = lambda t: float(np.sum(np_fn(*[f64(a) + t * u for a, u in zip(args, us)]) ** 2))
    numeric = (np_loss(eps) - np_loss(-eps)) / (2 * eps)
    assert abs(analytic - numeric) <= rtol * max(1.0, abs(numeric)), (analytic, numeric)


# --------------------------------------------------------------------------


class TestFlashAttention:
    """``ops.attention`` (the XLA path on this backend) vs NumPy."""

    @pytest.mark.parametrize("nq,nk", [(65, 65), (197, 197), (2, 66), (130, 257)])
    def test_matches_reference(self, nq, nk):
        b, h, d = 2, 4, 64
        q, k, v = rand(0, (b, h, nq, d)), rand(1, (b, h, nk, d)), rand(2, (b, h, nk, d))
        out = ops.attention(q, k, v)
        np.testing.assert_allclose(out, np_attention(q, k, v), atol=2e-5, rtol=2e-5)

    @pytest.mark.parametrize("bias_shape", [(1, 4, 50, 50), (2, 1, 50, 50), (1, 1, 50, 50), (2, 4, 50, 50)])
    def test_bias_broadcasting(self, bias_shape):
        b, h, n, d = 2, 4, 50, 32
        q, k, v = rand(0, (b, h, n, d)), rand(1, (b, h, n, d)), rand(2, (b, h, n, d))
        bias = rand(3, bias_shape)
        out = ops.attention(q, k, v, bias)
        np.testing.assert_allclose(out, np_attention(q, k, v, bias), atol=2e-5, rtol=2e-5)

    def test_diag_self_mask(self):
        b, h, n, d = 1, 2, 37, 16
        q, k, v = rand(0, (b, h, n, d)), rand(1, (b, h, n, d)), rand(2, (b, h, n, d))
        out = ops.attention(q, k, v, mask_self=True)
        ref = np_attention(q, k, v, mask_self=True)
        np.testing.assert_allclose(out, ref, atol=2e-5, rtol=2e-5)

    def test_bf16(self):
        b, h, n, d = 2, 8, 197, 64
        q = rand(0, (b, h, n, d), jnp.bfloat16)
        k = rand(1, (b, h, n, d), jnp.bfloat16)
        v = rand(2, (b, h, n, d), jnp.bfloat16)
        out = ops.attention(q, k, v)
        assert out.dtype == jnp.bfloat16
        np.testing.assert_allclose(
            np.asarray(out, np.float32), np_attention(q, k, v), atol=2e-2, rtol=2e-2
        )

    def test_custom_scale(self):
        b, h, n, d = 1, 2, 30, 32
        q, k, v = rand(0, (b, h, n, d)), rand(1, (b, h, n, d)), rand(2, (b, h, n, d))
        out = ops.attention(q, k, v, scale=0.25)
        np.testing.assert_allclose(out, np_attention(q, k, v, scale=0.25), atol=2e-5, rtol=2e-5)


class TestFlashAttentionKVBlocked:
    """Long and ragged sequences, bias with the diagonal mask, a value
    width that differs from the key width, bf16 and gradients."""

    @pytest.mark.parametrize("nq,nk", [(65, 65), (130, 257), (2, 300), (197, 515)])
    def test_matches_reference(self, nq, nk):
        b, h, d = 2, 2, 32
        q, k, v = rand(0, (b, h, nq, d)), rand(1, (b, h, nk, d)), rand(2, (b, h, nk, d))
        np.testing.assert_allclose(ops.attention(q, k, v), np_attention(q, k, v), atol=2e-5, rtol=2e-5)

    def test_bias_and_mask(self):
        b, h, n, d = 2, 2, 260, 32
        q, k, v = rand(0, (b, h, n, d)), rand(1, (b, h, n, d)), rand(2, (b, h, n, d))
        bias = rand(3, (1, h, n, n))
        out = ops.attention(q, k, v, bias, mask_self=True)
        ref = np_attention(q, k, v, bias, mask_self=True)
        np.testing.assert_allclose(out, ref, atol=2e-5, rtol=2e-5)

    def test_wide_dv(self):
        b, h, nq, nk, d, dv = 1, 2, 64, 384, 32, 64
        q, k = rand(0, (b, h, nq, d)), rand(1, (b, h, nk, d))
        v = rand(2, (b, h, nk, dv))
        out = ops.attention(q, k, v)
        assert out.shape == (b, h, nq, dv)
        np.testing.assert_allclose(out, np_attention(q, k, v), atol=2e-5, rtol=2e-5)

    def test_bf16(self):
        b, h, n, d = 1, 2, 300, 32
        q = rand(0, (b, h, n, d), jnp.bfloat16)
        k = rand(1, (b, h, n, d), jnp.bfloat16)
        v = rand(2, (b, h, n, d), jnp.bfloat16)
        out = ops.attention(q, k, v)
        assert out.dtype == jnp.bfloat16
        np.testing.assert_allclose(
            np.asarray(out, np.float32), np_attention(q, k, v), atol=2e-2, rtol=2e-2
        )

    def test_grads_match_reference(self):
        b, h, n, d = 1, 2, 140, 16
        q, k, v = rand(0, (b, h, n, d)), rand(1, (b, h, n, d)), rand(2, (b, h, n, d))
        out, vjp = jax.vjp(ops.attention, q, k, v)
        got = vjp(2 * out)  # d sum(out**2)
        ref = np_attention_grads(q, k, v, None, 2 * f64(out))
        for a, r in zip(got, ref):
            np.testing.assert_allclose(np.asarray(a), r, atol=1e-4, rtol=1e-4)


class TestFusedQKVAttention:
    """``ops.qkv_attention`` on the fused ``[B, N, 3*H*D]`` layout."""

    @staticmethod
    def _ref(qkv, heads, bias=None):
        b, n, three_hd = qkv.shape
        d = three_hd // 3 // heads
        q, k, v = f64(qkv).reshape(b, n, 3, heads, d).transpose(2, 0, 3, 1, 4)
        return np_merge(np_attention(q, k, v, bias))

    @pytest.mark.parametrize("n,heads,d", [(197, 16, 64), (64, 4, 32), (50, 2, 48)])
    def test_matches_split_path(self, n, heads, d):
        qkv = rand(0, (2, n, 3 * heads * d))
        out = ops.qkv_attention(qkv, heads)
        np.testing.assert_allclose(out, self._ref(qkv, heads), atol=2e-5, rtol=2e-5)

    def test_with_bias_and_ragged_q_blocks(self):
        b, n, heads, d = 2, 300, 4, 32
        qkv = rand(0, (b, n, 3 * heads * d))
        bias = rand(1, (1, heads, n, n))
        out = ops.qkv_attention(qkv, heads, bias)
        np.testing.assert_allclose(out, self._ref(qkv, heads, bias), atol=2e-5, rtol=2e-5)


class TestFusedMLP:
    """``ops.mlp`` (LN -> GEMM -> act -> GEMM -> +x) vs NumPy."""

    @pytest.mark.parametrize("t,d,f", [(65, 96, 384), (197, 128, 512), (64, 256, 1100)])
    def test_matches_reference(self, t, d, f):
        x = rand(0, (2, t, d))
        w1, b1 = rand(1, (d, f)), rand(2, (f,))
        w2, b2 = rand(3, (f, d)), rand(4, (d,))
        g, bl = rand(5, (d,)), rand(6, (d,))
        out = ops.mlp(x, w1, b1, w2, b2, g, bl)
        ref = np_mlp(x, w1, b1, w2, b2, g, bl)
        np.testing.assert_allclose(out, ref, atol=1e-3, rtol=1e-3)

    def test_no_ln_no_residual(self):
        x = rand(0, (1, 50, 64))
        w1, w2 = rand(1, (64, 128)), rand(2, (128, 64))
        out = ops.mlp(x, w1, None, w2, None, residual=False)
        ref = np_mlp(x, w1, None, w2, None, residual=False)
        np.testing.assert_allclose(out, ref, atol=1e-3, rtol=1e-4)

    def test_hard_swish(self):
        x = rand(0, (1, 49, 64))
        w1, b1 = rand(1, (64, 128)), rand(2, (128,))
        w2, b2 = rand(3, (128, 64)), rand(4, (64,))
        out = ops.mlp(x, w1, b1, w2, b2, activation="hard_swish")
        ref = np_mlp(x, w1, b1, w2, b2, activation="hard_swish")
        np.testing.assert_allclose(out, ref, atol=1e-3, rtol=1e-4)


class TestFusedAttentionBlock:
    """The raw-parameter ``Attention`` module with the residual add (the
    encoder block's attention half) vs the NumPy block."""

    @staticmethod
    def _module(dim, heads, d):
        from vitax.nn.attention import Attention

        return Attention(dim=dim, heads=heads, dim_head=d, fuse_residual=True)

    @staticmethod
    def _np(params, x, heads):
        p = params["params"]
        return np_block(x, p["norm_scale"], p["norm_bias"], p["qkv_kernel"],
                        p["out_kernel"], p["out_bias"], heads)

    def test_matches_xla(self):
        b, n, dim, heads, d = 2, 65, 64, 4, 16
        x = rand(0, (b, n, dim))
        m = self._module(dim, heads, d)
        params = m.init({"params": jax.random.PRNGKey(1)}, x)
        np.testing.assert_allclose(m.apply(params, x), self._np(params, x, heads), atol=1e-4, rtol=1e-4)

    @pytest.mark.parametrize("n", [50, 64, 197])
    def test_token_padding_path(self, n):
        # unaligned token counts run as they are: no padding, same shape
        b, dim, heads, d = 3, 48, 3, 16
        x = rand(0, (b, n, dim))
        m = self._module(dim, heads, d)
        params = m.init({"params": jax.random.PRNGKey(2)}, x)
        out = m.apply(params, x)
        assert out.shape == x.shape
        np.testing.assert_allclose(out, self._np(params, x, heads), atol=1e-4, rtol=1e-4)

    def test_grads_match_xla(self):
        b, n, dim, heads, d = 1, 30, 32, 2, 16
        args = (rand(0, (b, n, dim)), rand(1, (dim,)), rand(2, (dim,)),
                rand(3, (dim, 3 * heads * d)) * 0.1,
                rand(4, (heads * d, dim)) * 0.1, rand(5, (dim,)) * 0.1)
        m = self._module(dim, heads, d)

        def fwd(x, ns, nb, wqkv, wout, bout):
            p = {"norm_scale": ns, "norm_bias": nb, "qkv_kernel": wqkv,
                 "out_kernel": wout, "out_bias": bout}
            return m.apply({"params": p}, x)

        directional_check(fwd, lambda *a: np_block(*a, heads), args)


class TestCustomVJP:
    """Gradients through the attention ops against the analytic NumPy
    backward (and, for the MLP, finite differences)."""

    def test_qkv_attention_grads_match_xla(self):
        b, n, heads, d = 2, 50, 4, 32
        qkv = rand(0, (b, n, 3 * heads * d))
        bias = rand(1, (1, heads, n, n))
        out, vjp = jax.vjp(lambda a, c: ops.qkv_attention(a, heads, c), qkv, bias)
        g = 2 * f64(out)
        dqkv, dbias = vjp(2 * out)
        q, k, v = f64(qkv).reshape(b, n, 3, heads, d).transpose(2, 0, 3, 1, 4)
        gh = g.reshape(b, n, heads, d).transpose(0, 2, 1, 3)
        dq, dk, dv, db = np_attention_grads(q, k, v, bias, gh)
        ref = np.stack([dq, dk, dv]).transpose(1, 3, 0, 2, 4).reshape(b, n, 3 * heads * d)
        np.testing.assert_allclose(np.asarray(dqkv), ref, atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(np.asarray(dbias), db, atol=1e-4, rtol=1e-4)

    def test_flash_attention_grads_match_xla(self):
        b, h, n, d = 2, 3, 40, 16
        q, k, v = rand(0, (b, h, n, d)), rand(1, (b, h, n, d)), rand(2, (b, h, n, d))
        bias = rand(3, (1, h, n, n))
        for mask_self in (False, True):
            f = lambda *a: ops.attention(*a, mask_self=mask_self)
            out, vjp = jax.vjp(f, q, k, v, bias)
            got = vjp(2 * out)
            ref = np_attention_grads(q, k, v, bias, 2 * f64(out), mask_self=mask_self)
            for a, r in zip(got, ref):
                np.testing.assert_allclose(np.asarray(a), r, atol=2e-4, rtol=2e-4)
        # bias=None
        out, vjp = jax.vjp(lambda q: ops.attention(q, k, v), q)
        (dq,) = vjp(2 * out)
        ref = np_attention_grads(q, k, v, None, 2 * f64(out))[0]
        np.testing.assert_allclose(np.asarray(dq), ref, atol=2e-4, rtol=2e-4)

    @pytest.mark.parametrize("nq,nk,bias_shape,mask_self", [
        (33, 33, (1, 1, 33, 33), False),  # bias shared by batch and heads
        (64, 64, (1, 2, 64, 64), False),  # per-head bias
        (40, 40, None, True),             # diagonal mask
    ])
    def test_flash_chunked_backward_matches_reference_vjp(self, nq, nk, bias_shape, mask_self):
        b, h, d = 2, 2, 8
        q, k, v = rand(0, (b, h, nq, d)), rand(1, (b, h, nk, d)), rand(2, (b, h, nk, d))
        bias = rand(3, bias_shape) if bias_shape else None
        args = (q, k, v) if bias is None else (q, k, v, bias)
        f = lambda *a: ops.attention(*a, mask_self=mask_self)
        out, vjp = jax.vjp(f, *args)
        got = vjp(2 * out)
        ref = np_attention_grads(q, k, v, bias, 2 * f64(out), mask_self=mask_self)
        for a, r in zip(got, ref):
            np.testing.assert_allclose(np.asarray(a), r, atol=2e-4, rtol=1e-3)

    def test_fused_mlp_grads_match_xla(self):
        x = rand(0, (2, 40, 64))
        w1, b1 = rand(1, (64, 128)) * 0.1, rand(2, (128,)) * 0.1
        w2, b2 = rand(3, (128, 64)) * 0.1, rand(4, (64,)) * 0.1
        g, bl = rand(5, (64,)), rand(6, (64,))
        directional_check(ops.mlp, np_mlp, (x, w1, b1, w2, b2, g, bl))


class TestAttentionRoute:
    """Which attention ``ops.attention``/``ops.qkv_attention`` run: cuDNN's
    fused kernel only on a GPU and only for what it takes, the XLA path for
    everything else — decided from dtype, shapes, bias, mask and scale."""

    @staticmethod
    def _qkv(dtype=jnp.bfloat16, d=64, dv=None):
        q = jnp.zeros((2, 4, 17, d), dtype)
        return q, q, jnp.zeros((2, 4, 17, dv or d), dtype)

    def test_cpu_backend_takes_xla(self):
        assert jax.default_backend() == "cpu"
        assert not uses_cudnn(*self._qkv())

    @pytest.mark.parametrize("case,expect", [
        ("bf16", True), ("fp16", True), ("fp32", False), ("bias", False),
        ("mask_self", False), ("wide_dv", False), ("d12", False),
        ("d256", False), ("traced_scale", False),
    ])
    def test_gpu_route(self, monkeypatch, case, expect):
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        kw, args = {}, self._qkv()
        if case == "fp16":
            args = self._qkv(jnp.float16)
        elif case == "fp32":
            args = self._qkv(jnp.float32)
        elif case == "bias":
            kw["bias"] = jnp.zeros((1, 4, 17, 17))
        elif case == "mask_self":
            kw["mask_self"] = True
        elif case == "wide_dv":
            args = self._qkv(dv=128)
        elif case == "d12":
            args = self._qkv(d=12)
        elif case == "d256":
            args = self._qkv(d=256)
        elif case == "traced_scale":
            kw["scale"] = jnp.float32(0.125)
        assert uses_cudnn(*args, **kw) is expect

    def test_cudnn_route_under_autodiff_is_the_reference(self, monkeypatch):
        """Undifferentiated, the cuDNN route calls cuDNN (here a spy standing
        in for it); differentiated, it runs the XLA path forward and back."""
        from vitax.ops import attention_core

        calls = []
        xla_dpa = jax.nn.dot_product_attention
        monkeypatch.setattr(
            jax.nn, "dot_product_attention",
            lambda q, k, v, scale=None, implementation=None: calls.append(implementation)
            or xla_dpa(q, k, v, scale=scale, implementation="xla"),
        )
        q, k, v = rand(0, (2, 9, 3, 8)), rand(1, (2, 9, 3, 8)), rand(2, (2, 9, 3, 8))
        attention_core._cudnn_bnhd(q, k, v, 0.3)
        assert calls == ["cudnn"]
        out, vjp = jax.vjp(lambda *a: attention_core._cudnn_bnhd(*a, 0.3), q, k, v)
        assert calls == ["cudnn"]
        t = lambda a: f64(a).transpose(0, 2, 1, 3)
        np.testing.assert_allclose(t(out), np_attention(t(q), t(k), t(v), scale=0.3), atol=2e-5)
        got = vjp(2 * out)
        ref = np_attention_grads(t(q), t(k), t(v), None, 2 * t(out), scale=0.3)
        for a, r in zip(got, ref):
            np.testing.assert_allclose(t(a), r, atol=1e-4, rtol=1e-4)

    @pytest.mark.parametrize("shape,heads", [((3, 10, 3 * 4 * 8), 4), ((1, 197, 3 * 16 * 64), 16)])
    def test_qkv_shapes_and_dtype(self, shape, heads):
        qkv = rand(0, shape, jnp.bfloat16)
        out = ops.qkv_attention(qkv, heads)
        assert out.shape == (shape[0], shape[1], shape[2] // 3)
        assert out.dtype == jnp.bfloat16


class TestPatchOps:
    def test_patchify_roundtrip(self):
        x = rand(0, (2, 32, 32, 3))
        p = patchify(x, 8)
        assert p.shape == (2, 16, 192)
        x2 = unpatchify(p, 4, 4, 8, 8, 3)
        np.testing.assert_array_equal(x, x2)

    def test_patchify_matches_einops_order(self):
        import einops

        x = rand(0, (2, 16, 16, 3))
        p = patchify(x, 4)
        ref = einops.rearrange(x, "b (h p1) (w p2) c -> b (h w) (p1 p2 c)", p1=4, p2=4)
        np.testing.assert_array_equal(p, ref)

    def test_extract_patches_matches_tf_order(self):
        # Feature order must match tf.image.extract_patches for T2T parity
        # (SURVEY.md §7.3 item 4). Verified against TF directly when present.
        tf = pytest.importorskip("tensorflow")
        x = np.asarray(rand(0, (1, 14, 14, 5)))
        ours = extract_patches(jnp.asarray(x), kernel=3, stride=2, padding="SAME")
        theirs = tf.image.extract_patches(
            x, sizes=[1, 3, 3, 1], strides=[1, 2, 2, 1], rates=[1, 1, 1, 1], padding="SAME"
        ).numpy()
        np.testing.assert_allclose(np.asarray(ours), theirs, atol=1e-6)

    def test_extract_patches_matches_tf_order_valid(self):
        # PiT's overlapping patchify uses VALID padding (pit.py:212-218,
        # stride = patch/2); pin that path to TF bit-for-bit too.
        tf = pytest.importorskip("tensorflow")
        x = np.asarray(rand(1, (2, 17, 17, 3)))
        ours = extract_patches(jnp.asarray(x), kernel=4, stride=2, padding="VALID")
        theirs = tf.image.extract_patches(
            x, sizes=[1, 4, 4, 1], strides=[1, 2, 2, 1], rates=[1, 1, 1, 1], padding="VALID"
        ).numpy()
        np.testing.assert_allclose(np.asarray(ours), theirs, atol=1e-6)

    def test_spt_shifts(self):
        x = rand(0, (1, 8, 8, 3))
        out = spt_shifts(x)
        assert out.shape == (1, 8, 8, 15)
        # center copy is the input itself
        np.testing.assert_array_equal(out[..., :3], x)


class TestWindowOps:
    def test_window_partition_matches_einops(self):
        import einops

        from vitax.ops import window_partition, window_unpartition

        x = rand(0, (2, 8, 8, 5))
        out = window_partition(x, 4)
        ref = einops.rearrange(x, "b (h s1) (w s2) d -> (b h w) (s1 s2) d", s1=4, s2=4)
        np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))
        back = window_unpartition(out, 4, 8, 8)
        np.testing.assert_array_equal(np.asarray(back), np.asarray(x))

    def test_dilated_partition_matches_einops(self):
        import einops

        from vitax.ops import dilated_partition, dilated_unpartition

        x = rand(0, (2, 8, 8, 5))
        out = dilated_partition(x, 4)
        ref = einops.rearrange(x, "b (l1 h) (l2 w) d -> (b h w) (l1 l2) d", l1=4, l2=4)
        np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))
        back = dilated_unpartition(out, 4, 8, 8)
        np.testing.assert_array_equal(np.asarray(back), np.asarray(x))

    def test_block_partition_roundtrip(self):
        from vitax.ops import block_partition, block_unpartition

        x = rand(0, (2, 8, 8, 3))
        out = block_partition(x, 2)
        assert out.shape == (8, 4, 4, 3)
        np.testing.assert_array_equal(np.asarray(block_unpartition(out, 2)), np.asarray(x))


class TestWindowAttentionBlock:
    def _args(self, nw=6, s=49, c=64, heads=2, d=32):
        xw = rand(0, (nw, s, c))
        ln_s, ln_b = rand(1, (c,)), rand(2, (c,))
        wqkv = rand(3, (c, 3 * heads * d)) * 0.1
        wout = rand(4, (heads * d, c)) * 0.1
        bout = rand(5, (c,)) * 0.1
        bias = rand(6, (heads, s, s)) * 0.5
        return xw, ln_s, ln_b, wqkv, wout, bout, bias, heads

    def test_matches_xla(self):
        xw, ln_s, ln_b, wqkv, wout, bout, bias, heads = self._args()
        out = ops.window_attention_block(xw, ln_s, ln_b, wqkv, wout, bout, heads, bias)
        ref = np_window_block(xw, ln_s, ln_b, wqkv, wout, bout, heads, bias)
        np.testing.assert_allclose(np.asarray(out), ref, atol=2e-4, rtol=2e-4)

    def test_no_bias_shared_bias_and_ragged_group(self):
        xw, ln_s, ln_b, wqkv, wout, bout, bias, heads = self._args(nw=5, s=16, c=32, d=16)
        for b in (None, bias[:1]):  # no bias; one (1, S, S) tile for all heads
            out = ops.window_attention_block(xw, ln_s, ln_b, wqkv, wout, bout, heads, b)
            ref = np_window_block(xw, ln_s, ln_b, wqkv, wout, bout, heads, b)
            np.testing.assert_allclose(np.asarray(out), ref, atol=2e-4, rtol=2e-4)

    def test_grads_match_xla(self):
        xw, ln_s, ln_b, wqkv, wout, bout, bias, heads = self._args(nw=2, s=9, c=16, d=8)
        directional_check(
            lambda *a: ops.window_attention_block(*a[:6], heads, a[6]),
            lambda *a: np_window_block(*a[:6], heads, a[6]),
            (xw, ln_s, ln_b, wqkv, wout, bout, bias),
        )


class TestReattentionBlock:
    def _args(self, b, n, dim, heads, d):
        hd = heads * d
        return (
            rand(0, (b, n, dim)),
            rand(1, (dim,)) * 0.1 + 1, rand(2, (dim,)) * 0.1,
            rand(3, (dim, 3 * hd)) * 0.1, rand(4, (hd, dim)) * 0.1,
            rand(5, (dim,)) * 0.1, rand(6, (heads, heads)) * 0.3,
            rand(7, (heads,)) * 0.1 + 1, rand(8, (heads,)) * 0.1,
        )

    @pytest.mark.parametrize("n", [50, 64, 65])
    def test_matches_xla(self, n):
        args = self._args(2, n, 48, 3, 16)
        out = ops.reattention_block(*args, 3)
        assert out.shape == args[0].shape
        np.testing.assert_allclose(out, np_reattention_block(*args, 3), atol=1e-4, rtol=1e-4)

    def test_grads_match_xla(self):
        args = self._args(2, 33, 32, 2, 16)
        directional_check(
            lambda *a: ops.reattention_block(*a, 2),
            lambda *a: np_reattention_block(*a, 2), args,
        )


class TestTalkingHeadsBlock:
    def _args(self, b, n, dim, heads, d):
        hd = heads * d
        return (
            rand(0, (b, n, dim)),
            rand(1, (dim,)) * 0.1 + 1, rand(2, (dim,)) * 0.1,
            rand(3, (dim, 3 * hd)) * 0.1, rand(4, (hd, dim)) * 0.1,
            rand(5, (dim,)) * 0.1,
            rand(6, (heads, heads)) * 0.3, rand(7, (heads, heads)) * 0.3,
        )

    @pytest.mark.parametrize("n,residual", [(50, False), (64, True), (65, False)])
    def test_matches_xla(self, n, residual):
        args = self._args(2, n, 48, 3, 16)
        out = ops.talking_heads_block(*args, 3, residual=residual)
        assert out.shape == args[0].shape
        ref = np_talking_heads_block(*args, 3, residual=residual)
        np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)

    def test_grads_match_xla(self):
        args = self._args(2, 33, 32, 2, 16)
        directional_check(
            lambda *a: ops.talking_heads_block(*a, 2),
            lambda *a: np_talking_heads_block(*a, 2), args,
        )
