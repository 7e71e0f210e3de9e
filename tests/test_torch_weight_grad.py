"""The train backwards' weight-gradient reduction on its own
(``alignsdf_torch.kernels.weight_grad``): its bf16 plain version against
the JAX package's ``mm_t_lhs`` formula (``decoder_train_kernel.py:609-612``:
``lax.dot_general`` of bf16 operands contracting the points, float32
results), and the wrapper's refusals.  On the CPU the wrapper runs the plain
version; the kernels are held against it on the card
(``tests/test_torch_cuda.py``).  ``weight_grads`` runs a list of calls as
a backward launches them, and on the CPU gives each call's plain result."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from alignsdf_torch.kernels.weight_grad import (weight_grad, weight_grad_plan,
                                                weight_grad_reference, weight_grads)


def _mm_t_lhs(x, d):
    """JAX's mm_t_lhs: x (points, K) bf16 against d (points, N) cast to bf16,
    contracted over the points, float32 sums."""
    return jax.lax.dot_general(x, d.astype(jnp.bfloat16), (((0,), (0,)), ((), ())),
                               preferred_element_type=jnp.float32)


def _operands(k, n, m, seed):
    rng = np.random.default_rng(seed)
    x = np.maximum(rng.normal(size=(m, k)), 0).astype(np.float32)  # a ReLU activation
    d = (rng.normal(size=(m, n)) * 1e-2).astype(np.float32)  # a pre-activation gradient
    return x, d


@pytest.mark.parametrize("k,n,m", [(6, 40, 96), (9, 1, 200), (33, 8, 4004), (40, 17, 256)])
def test_bf16_plain_matches_jax_mm_t_lhs(k, n, m):
    """Each entry within 1e-6 of |x_k| |d_n| (float32 sums of exact bf16
    products, in two orders), with and without a sum already in ``out``."""
    x, d = _operands(k, n, m, seed=k * n + m)
    ref = np.asarray(_mm_t_lhs(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(d)))
    a = torch.from_numpy(np.ascontiguousarray(x.T)).to(torch.bfloat16)
    b = torch.from_numpy(np.ascontiguousarray(d.T)).to(torch.bfloat16)
    scale = (np.linalg.norm(a.double().numpy(), axis=1)[:, None]
             * np.linalg.norm(b.double().numpy(), axis=1)[None, :])
    before = weight_grad.bf16_launches
    c = weight_grad(a, b)
    assert c.shape == (k, n) and c.dtype == torch.float32
    assert np.all(np.abs(c.numpy() - ref) <= 1e-6 * scale + 1e-30)
    prior = np.random.default_rng(1).normal(size=(k, n)).astype(np.float32)
    out = torch.from_numpy(prior.copy())
    assert weight_grad(a, b, out=out) is out
    assert np.all(np.abs(out.numpy() - (prior + ref)) <= 1e-6 * scale + 1e-6 * np.abs(prior))
    assert torch.equal(weight_grad_reference(a, b), a.float() @ b.float().T)
    assert weight_grad.bf16_launches == before  # the plain version launches nothing


@pytest.mark.parametrize("case", ["mixed_dtypes", "float64", "lengths", "out_shape", "out_dtype",
                                  "out_strided"])
def test_weight_grad_refusals(case):
    """The wrapper raises on what no kernel takes: operands of two dtypes or
    of neither kernel's, unequal point counts, an ``out`` of another shape
    or dtype, or not contiguous."""
    a = torch.randn(8, 64).to(torch.bfloat16)
    b = torch.randn(4, 64).to(torch.bfloat16)
    out = None
    if case == "mixed_dtypes":
        b = b.float()
    elif case == "float64":
        a, b = a.double(), b.double()
    elif case == "lengths":
        b = torch.randn(4, 60).to(torch.bfloat16)
    elif case == "out_shape":
        out = torch.zeros(4, 8)
    elif case == "out_dtype":
        out = torch.zeros(8, 4, dtype=torch.float64)
    else:
        out = torch.zeros(4, 8).T
    with pytest.raises(ValueError):
        weight_grad(a, b, out=out)


@pytest.mark.parametrize("k,n,m", [(512, 512, 4002), (0, 8, 64), (8, 8, 0)])
def test_weight_grad_plan_refuses_outside_the_kernel(k, n, m):
    """The bf16 launcher's plan is asked only for shapes its kernel takes
    (m % 4 == 0, nothing empty); the refusal comes before any build."""
    with pytest.raises(ValueError):
        weight_grad_plan(k, n, m)


def test_weight_grads_run_matches_jax_mm_t_lhs():
    """A run of a step's kinds of call (a hidden layer, the embedding's dX,
    the final layer), one of them into an ``out`` holding a sum: each
    result as ``weight_grad`` gives it alone, and within 1e-6 of |x_k|
    |d_n| of JAX's mm_t_lhs."""
    shapes = [(40, 40, 256), (9, 40, 256), (40, 2, 256)]
    pairs, refs, scales = [], [], []
    for i, (k, n, m) in enumerate(shapes):
        x, d = _operands(k, n, m, seed=100 + i)
        refs.append(np.asarray(_mm_t_lhs(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(d))))
        a = torch.from_numpy(np.ascontiguousarray(x.T)).to(torch.bfloat16)
        b = torch.from_numpy(np.ascontiguousarray(d.T)).to(torch.bfloat16)
        pairs.append((a, b))
        scales.append(np.linalg.norm(a.double().numpy(), axis=1)[:, None]
                      * np.linalg.norm(b.double().numpy(), axis=1)[None, :])
    prior = np.random.default_rng(2).normal(size=(9, 40)).astype(np.float32)
    outs = [None, torch.from_numpy(prior.copy()), None]
    before = weight_grad.bf16_launches
    cs = weight_grads(pairs, outs)
    assert weight_grad.bf16_launches == before and cs[1] is outs[1]
    for i, ((a, b), c, ref, scale) in enumerate(zip(pairs, cs, refs, scales)):
        start = prior if i == 1 else 0.0
        alone = weight_grad(a, b)
        assert torch.equal(c, torch.from_numpy(prior) + alone if i == 1 else alone)
        assert np.all(np.abs(c.numpy() - (start + ref)) <= 1e-6 * scale + 1e-6 * np.abs(start))


@pytest.mark.parametrize("case", ["outs_length", "bad_pair", "bad_out"])
def test_weight_grads_refusals(case):
    """A run raises, before it computes anything, for a list of outs that
    does not match its pairs, or for any call ``weight_grad`` refuses."""
    a = torch.randn(8, 64).to(torch.bfloat16)
    b = torch.randn(4, 64).to(torch.bfloat16)
    pairs, outs = [(a, b), (a, b)], [torch.zeros(8, 4), torch.zeros(8, 4)]
    if case == "outs_length":
        outs = outs[:1]
    elif case == "bad_pair":
        pairs[1] = (a, b.float())
    else:
        outs[1] = torch.zeros(4, 8)
    with pytest.raises(ValueError):
        weight_grads(pairs, outs)
    assert not outs[0].any()  # nothing was added before the refusal
