"""Flash attention (TPU kernel 15) in the port: the plain version of the
CUDA kernel against the JAX package's reference and Pallas kernel.

The same seeded inputs go through ``repro.kernels.flash_attention``
(``ref.attention_ref``, and ``kernel.flash_attention`` in interpret mode,
as the reference's own tests run it) and through the port's wrapper,
which runs the plain version (``ref.py``) for CPU tensors.  The cases and
tolerances are the reference test's (``tests/test_kernels.py``): float32
at rtol = atol = 2e-5, bfloat16 at 0.1, and the GQA wrapper.  The kernel
route takes exactly the shapes the reference kernel takes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import kernel as fak
from repro.kernels.flash_attention import ops as fao
from repro.kernels.flash_attention import ref as far
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention import ops as O
from repro_torch.kernels.flash_attention import ref as R

torch.set_num_threads(1)


def _qkv(rng, shape, dtype=np.float32):
    return [rng.standard_normal(shape).astype(dtype) for _ in range(3)]


def _bf16(a):
    """numpy float32 -> (jnp bfloat16, torch bfloat16) of the same
    values."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j, np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("seq,d", [(128, 64), (256, 64), (384, 128)])
def test_plain_version_matches_reference_and_pallas(causal, seq, d):
    rng = np.random.default_rng(seq + d)
    q, k, v = _qkv(rng, (2, seq, d))
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    pallas = np.asarray(fak.flash_attention(jq, jk, jv, causal=causal,
                                            block_q=128, block_k=128))
    ref = np.asarray(far.attention_ref(jq, jk, jv, causal=causal))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    before = K.flash_attention.launches
    got = K.flash_attention(tq, tk, tv, causal)
    assert K.flash_attention.launches == before      # no kernel on the CPU
    assert got.dtype == torch.float32 and got.shape == (2, seq, d)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), pallas, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(R.attention_ref(tq, tk, tv, causal).numpy(),
                               ref, rtol=2e-5, atol=2e-5)


def test_bf16_matches_pallas():
    rng = np.random.default_rng(0)
    (jq, tq), (jk, tk), (jv, tv) = (_bf16(x) for x in
                                    _qkv(rng, (1, 256, 64)))
    pallas = fak.flash_attention(jq, jk, jv, causal=True)
    got = K.flash_attention(tq, tk, tv, True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(pallas, np.float32),
                               rtol=0.1, atol=0.1)
    # the same function: equal to the reference's plain version after its
    # own bf16 rounding
    ref = far.attention_ref(jq, jk, jv, causal=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32),
                               rtol=0, atol=2 ** -7)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_gqa_mha_matches_reference(use_kernel):
    rng = np.random.default_rng(9)
    q = rng.standard_normal((2, 8, 128, 64)).astype(np.float32)
    k = rng.standard_normal((2, 2, 128, 64)).astype(np.float32)
    v = rng.standard_normal((2, 2, 128, 64)).astype(np.float32)
    ref = fao.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=True, use_pallas=False)
    got = O.mha(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                causal=True, use_kernel=use_kernel)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)
    # head h reads KV head h // 4 (jnp.repeat along heads)
    one = R.attention_ref(torch.from_numpy(q[:, 5]), torch.from_numpy(k[:, 1]),
                          torch.from_numpy(v[:, 1]), True)
    np.testing.assert_allclose(got[:, 5].numpy(), one.numpy(), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("seq", [7, 64, 128, 200, 256, 300])
def test_kernel_route_takes_the_reference_kernels_shapes(seq):
    rng = np.random.default_rng(seq)
    q, k, v = _qkv(rng, (1, seq, 32))
    try:
        want = np.asarray(fak.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True))
    except AssertionError:
        want = None
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    if want is None:
        with pytest.raises(ValueError, match="multiple of"):
            K.flash_attention(tq, tk, tv, True)
        with pytest.raises(ValueError, match="multiple of"):
            O.mha(tq[None], tk[None], tv[None])
        # the plain route takes any shape, as use_pallas=False does
        O.mha(tq[None], tk[None], tv[None], use_kernel=False)
    else:
        np.testing.assert_allclose(K.flash_attention(tq, tk, tv, True)
                                   .numpy(), want, rtol=2e-5, atol=2e-5)


def test_kernel_route_refuses_mismatched_shapes():
    x = torch.zeros((2, 64, 32))
    with pytest.raises(ValueError, match="shape"):
        K.flash_attention(x, torch.zeros((2, 128, 32)), x)
    with pytest.raises(ValueError, match="shape"):
        K.flash_attention(x[0], x[0], x[0])
    with pytest.raises(ValueError, match="divide"):
        O.mha(torch.zeros((1, 6, 64, 32)), torch.zeros((1, 4, 64, 32)),
              torch.zeros((1, 4, 64, 32)))


def _bshd(rng, b, s, h, d):
    """A seeded [b, s, h, d] array and its [b, h, s, d] torch view."""
    a = rng.standard_normal((b, s, h, d)).astype(np.float32)
    return a, torch.from_numpy(a).transpose(1, 2)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("h_kv", [1, 2, 4])
def test_mha_reads_strided_grouped_heads_in_place(h_kv, use_kernel, causal):
    """The forward's layout: q/k/v as [b, h, s, d] views of [b, s, h, d]
    tensors (not contiguous), KV heads read by index, against the JAX
    package's ``mha(use_pallas=False)`` (which repeats the KV heads)."""
    rng = np.random.default_rng(40 + h_kv)
    b, s, h, d = 2, 128, 4, 32
    (q, tq), (k, tk), (v, tv) = (_bshd(rng, b, s, n, d)
                                 for n in (h, h_kv, h_kv))
    assert not tq.is_contiguous()
    ref = fao.mha(*(jnp.asarray(x.transpose(0, 2, 1, 3)) for x in (q, k, v)),
                  causal=causal, use_pallas=False)
    got = O.mha(tq, tk, tv, causal=causal, use_kernel=use_kernel)
    assert got.shape == (b, h, s, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_mha_output_reshapes_to_bsh_without_a_copy(use_kernel):
    rng = np.random.default_rng(3)
    b, s, h, d = 2, 64, 4, 32
    _, tq = _bshd(rng, b, s, h, d)
    _, tk = _bshd(rng, b, s, 2, d)
    out = O.mha(tq, tk, tk, use_kernel=use_kernel)
    flat = out.transpose(1, 2).reshape(b, s, -1)
    assert flat.data_ptr() == out.data_ptr()
    assert flat._base is not None                 # a view, not a copy
    np.testing.assert_array_equal(flat[:, :, d:2 * d].numpy(),
                                  out[:, 1].numpy())


@pytest.mark.parametrize("case", ["inner_stride", "row_stride", "heads"])
def test_kernel_route_refuses_layouts_it_cannot_read(case):
    q = torch.zeros((1, 4, 64, 32))
    k = v = torch.zeros((1, 2, 64, 32))
    if case == "inner_stride":          # every other element of d
        q = torch.zeros((1, 4, 64, 64))[..., ::2]
        match = "innermost stride"
    elif case == "row_stride":          # rows 36 elements apart
        k = torch.zeros((1, 2, 64, 36))[..., :32]
        match = "multiple of 8"
    else:
        k = v = torch.zeros((1, 3, 64, 32))
        match = "divide"
    with pytest.raises(ValueError, match=match):
        O.mha(q, k, v)
    with pytest.raises(ValueError, match=match):
        K.flash_attention_into(q, k, v, torch.empty_like(q))
    # the plain route takes any layout (the reference's use_pallas=False)
    if case != "heads":
        O.mha(q, k, v, use_kernel=False)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seq_k", [256, 512])
@pytest.mark.parametrize("where", ["first", "middle", "last"])
def test_offset_queries_equal_the_references_matching_rows(where, seq_k,
                                                           dtype):
    """A stretch of 128 query rows starting at ``q_start`` (0, s_k / 2,
    s_k - s_q) against all s_k keys, 4 heads over 2 KV heads: the kernel
    route's plain version equals those rows of the reference's
    ``mha(use_pallas=False)`` over the whole sequence (float32 at 2e-5;
    bfloat16 within one rounding of the output, both computing in float32
    and rounding once)."""
    rng = np.random.default_rng(seq_k + len(where))
    s_q = 128
    q_start = {"first": 0, "middle": seq_k // 2, "last": seq_k - s_q}[where]
    q = rng.standard_normal((2, 4, seq_k, 64)).astype(np.float32)
    k, v = (rng.standard_normal((2, 2, seq_k, 64)).astype(np.float32)
            for _ in range(2))
    if dtype == "bfloat16":
        (jq, tq), (jk, tk), (jv, tv) = (_bf16(x) for x in (q, k, v))
    else:
        (jq, tq), (jk, tk), (jv, tv) = ((jnp.asarray(x), torch.from_numpy(x))
                                        for x in (q, k, v))
    want = np.asarray(fao.mha(jq, jk, jv, causal=True, use_pallas=False),
                      np.float32)[:, :, q_start:q_start + s_q]
    rows = tq[:, :, q_start:q_start + s_q]
    got = O.mha(rows, tk, tv, causal=True, q_start=q_start)
    assert got.dtype == tq.dtype and got.shape == rows.shape
    tol = 2e-5 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)
    np.testing.assert_allclose(
        R.attention_ref(rows, tk, tv, True, kv_group=2,
                        q_start=q_start).float().numpy(), want, rtol=tol,
        atol=tol)


def test_offset_queries_must_lie_inside_the_keys():
    q = torch.zeros((1, 2, 128, 32))
    k = torch.zeros((1, 2, 256, 32))
    with pytest.raises(ValueError, match="rows 192..320"):
        O.mha(q, k, k, q_start=192)
    with pytest.raises(ValueError, match="rows -1"):
        O.mha(q, k, k, q_start=-1)
