"""K4's gradient and its head-width rule in the PyTorch port, against the JAX package.

The port's ``flash_attention`` runs through ``FlashAttention``, an autograd
Function whose backward recomputes what JAX's custom VJP (``_padded_flash_bwd``)
does; on the CPU its forward is the kernel's plain version. The JAX side runs
``padded_flash_attention(interpret=True)`` under ``jax.grad``, and the flax
modules with ``SKYEYE_FLASH_INTERPRET=1``, as ``tests/test_pallas_kernels.py``
does. Inputs and output gradients are numpy from a seed.

Tolerances: gradients rtol 1e-4, atol 1e-5 (both sides recompute the same
float32 einsums, summed in another order; the attention outputs' own tolerance,
rtol 2e-4 / atol 2e-5, is for the forward's online softmax); module outputs
atol 1e-4, as ``tests/test_torch_port_attention.py`` holds them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from skyeye_tpu.models import attention as jatt
from skyeye_tpu.ops.pallas.attention_kernel import padded_flash_attention
from skyeye_tpu_torch.models import attention as tatt
from skyeye_tpu_torch.ops import attention_kernel as tak
from skyeye_tpu_torch.utils.checkpoint import from_jax_variables

GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
ATOL = 1e-4


def _arrays(seed, shape, count=4):
    rng = np.random.RandomState(seed)
    return [rng.normal(0, 1, shape).astype(np.float32) for _ in range(count)]


def _randomised(shapes, seed):
    """Seeded numpy values for every flax leaf of these shapes."""
    rng = np.random.RandomState(seed)
    out = {}
    for path, v in traverse_util.flatten_dict(shapes, sep="/").items():
        if path.endswith("kernel"):
            out[path] = rng.normal(0, 1, v.shape) / np.sqrt(np.prod(v.shape[:-1]))
        else:
            out[path] = rng.normal(0, 0.1, v.shape)
    return {k: v.astype(np.float32) for k, v in out.items()}


def _to_jax(flat):
    return traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                         for k, v in flat.items()})


@pytest.mark.parametrize("n,hd", [(37, 40), (300, 96)])
def test_function_gradients_match_jax_grad_of_padded_flash(n, hd):
    """dq, dk, dv through the autograd Function against jax.grad of the Pallas
    kernel (interpreted) with its custom VJP, at ragged N and hd."""
    q, k, v, g = _arrays(n * hd, (3, n, hd))

    def loss(q_, k_, v_):
        return jnp.sum(padded_flash_attention(q_, k_, v_, interpret=True) * jnp.asarray(g))

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = tak.flash_attention(tq, tk, tv)
    assert isinstance(out.grad_fn, tak.FlashAttention._backward_cls)
    out.backward(torch.from_numpy(g))
    for name, got, ref in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)


def test_backward_matches_autograd_of_the_einsum_reference():
    q, k, v, g = (torch.from_numpy(a) for a in _arrays(5, (2, 70, 24)))
    got = tak.flash_attention_backward(q, k, v, g)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(tak.attention_reference(*leaves), leaves, g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_without_grad_nothing_is_saved():
    """Under no_grad or inference_mode, or on inputs that need no gradient, the
    forward keeps no tensor for a backward."""
    q, k, v = (torch.from_numpy(a) for a in _arrays(6, (2, 40, 16), 3))
    packed = []

    def pack(t):
        packed.append(t.shape)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        with torch.no_grad():
            assert tak.flash_attention(*leaves).grad_fn is None
        with torch.inference_mode():
            tak.flash_attention(q, k, v)
        assert tak.flash_attention(q, k, v).grad_fn is None
        assert packed == []
        tak.flash_attention(*leaves)
        assert packed == [q.shape] * 3


def test_mhsa_weight_gradients_match_flax_in_train_mode(monkeypatch):
    """N = 256: both sides take the fused path (JAX through its custom VJP), and
    the qkv and proj weight gradients of sum(out * g) agree."""
    monkeypatch.setenv("SKYEYE_FLASH_INTERPRET", "1")
    calls = []
    real = tatt.flash_attention
    monkeypatch.setattr(tatt, "flash_attention",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    x, g = _arrays(256, (2, 256, 64), 2)
    jmod = jatt.MultiHeadSelfAttention(num_heads=4)
    flat = _randomised(jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.asarray(x)), 7)
    tmod = tatt.MultiHeadSelfAttention(64, 4)
    tmod.load_state_dict(from_jax_variables(flat), strict=True)
    tmod.train()

    def loss(params):
        return jnp.sum(jmod.apply({"params": params}, jnp.asarray(x)) * jnp.asarray(g))

    grads = jax.grad(loss)(_to_jax(flat)["params"])
    flat_grads = {f"params/{k}": np.array(v)
                  for k, v in traverse_util.flatten_dict(grads, sep="/").items()}
    want = from_jax_variables(flat_grads)
    (tmod(torch.from_numpy(x)) * torch.from_numpy(g)).sum().backward()
    assert calls == [(8, 256, 16)]
    for name, p in tmod.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)


def test_heads_wider_than_the_kernel_take_the_einsum_path_and_match_flax(monkeypatch):
    """C 640 over 2 heads is hd 320: JAX pads it to 384 lanes in its kernel; the
    port's gate sends it to the einsum path, which gives the same result."""
    monkeypatch.setenv("SKYEYE_FLASH_INTERPRET", "1")
    monkeypatch.setattr(tatt, "flash_attention",
                        lambda *a: pytest.fail("heads of 320 reached the kernel"))
    (x,) = _arrays(320, (2, 256, 640), 1)
    jmod = jatt.MultiHeadSelfAttention(num_heads=2)
    flat = _randomised(jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.asarray(x)), 8)
    ref = np.asarray(jmod.apply(_to_jax(flat), jnp.asarray(x)))
    tmod = tatt.MultiHeadSelfAttention(640, 2)
    tmod.load_state_dict(from_jax_variables(flat), strict=True)
    with torch.no_grad():
        got = tmod.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("n,hd,mask,want", [
    (256, 256, False, True),                    # the serving heads
    (256, tak.MAX_HEAD_DIM + 64, False, False),  # wider than the kernel holds
    (255, 64, False, False),                    # below JAX's token gate
    (400, 64, True, False),                     # a mask takes the einsum path
])
def test_flash_gate_is_a_shape_rule(n, hd, mask, want):
    m = torch.zeros(1) if mask else None
    assert tatt.takes_flash_path(n, hd, m, None) is want
