"""The port's kernels (``paddle_tpu_torch.ops.kernels``) against the JAX
package's Pallas kernels, and against their own plain versions on the card.

On the CPU each wrapper computes its plain PyTorch version; the same
numpy-seeded inputs go through the JAX kernel (run by the Pallas
interpreter, as ``tests/test_flash_attention.py`` and
``tests/test_pallas_kernels.py`` run it) and through the port. The
``cuda``-marked cases launch the hand-written kernels and skip without a
card. JAX is imported inside the tests that use it, so that the ``cuda``
cases also run where JAX is not installed::

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import math
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import kernels
from paddle_tpu_torch.ops.attention import sdpa_array
from paddle_tpu_torch.ops.kernels.flash_attention import (
    flash_attention_fwd, flash_attention_plain)
from paddle_tpu_torch.ops.kernels.paged_decode import (
    paged_decode_attention, paged_decode_plain)
from paddle_tpu_torch.serving import kv_cache as tkv

REPO = Path(__file__).resolve().parents[1]


def _qkv(seed, B=2, S=128, H=2, D=64):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, S, H, D).astype(np.float32) * 0.5
            for _ in range(3)]


# -- flash-attention forward ------------------------------------------------
@pytest.mark.parametrize("S", [128, 256])
def test_flash_forward_matches_jax_kernel(S):
    import jax.numpy as jnp
    from paddle_tpu.ops.pallas.flash_attention import flash_attention
    q, k, v = _qkv(S, S=S)
    ref = np.asarray(flash_attention(*map(jnp.asarray, (q, k, v)),
                                     causal=True))
    got = flash_attention_fwd(*map(torch.from_numpy, (q, k, v)),
                              causal=True)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=0)
    plain = flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                  causal=True)
    np.testing.assert_allclose(plain.numpy(), ref, atol=2e-5, rtol=0)


def test_flash_lse_matches_jax_residual():
    import jax.numpy as jnp
    from paddle_tpu.ops.pallas.flash_attention import _fwd
    q, k, v = _qkv(7, S=256)
    o_ref, lse_ref = _fwd(*map(jnp.asarray, (q, k, v)), None,
                          1.0 / math.sqrt(64), True, 128, 128)
    o, lse = flash_attention_fwd(*map(torch.from_numpy, (q, k, v)),
                                 causal=True, return_lse=True)
    assert lse.shape == (2, 2, 256) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref)[..., 0],
                               atol=2e-5, rtol=0)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=2e-5,
                               rtol=0)


def test_flash_ragged_and_rectangular_causal_is_bottom_right():
    """Any S works (no TPU tile constraint) and causal masking is
    bottom-right aligned when Sq < Sk, as ``tril(k=Sk-Sq)``."""
    rng = np.random.RandomState(3)
    q = torch.from_numpy(rng.randn(1, 5, 2, 64).astype(np.float32))
    k = torch.from_numpy(rng.randn(1, 9, 2, 64).astype(np.float32))
    v = torch.from_numpy(rng.randn(1, 9, 2, 64).astype(np.float32))
    o = flash_attention_fwd(q, k, v, causal=True)
    # the last query row sees every key: plain softmax attention
    s = torch.einsum("hd,khd->hk", q[0, -1], k[0]) / 8.0
    ref = torch.einsum("hk,khd->hd", torch.softmax(s, -1), v[0])
    torch.testing.assert_close(o[0, -1], ref, atol=1e-6, rtol=1e-6)
    # the first query row sees keys 0..Sk-Sq
    s0 = torch.einsum("hd,khd->hk", q[0, 0], k[0, :5]) / 8.0
    ref0 = torch.einsum("hk,khd->hd", torch.softmax(s0, -1), v[0, :5])
    torch.testing.assert_close(o[0, 0], ref0, atol=1e-6, rtol=1e-6)


def test_flash_wrapper_checks_arguments():
    q = torch.zeros(1, 4, 2, 64)
    with pytest.raises(ValueError, match="shape mismatch"):
        flash_attention_fwd(q, torch.zeros(1, 4, 3, 64),
                            torch.zeros(1, 4, 3, 64))
    with pytest.raises(ValueError, match="one dtype"):
        flash_attention_fwd(q, q.double(), q)
    with pytest.raises(ValueError, match="Sk"):
        flash_attention_fwd(q, q[:, :2], q[:, :2], causal=True)


def test_non_cpu_tensors_never_take_the_plain_version():
    """Off the CPU the attention paths launch a kernel or raise: nothing
    falls back to the plain version (meta tensors stand in for a device
    that has no kernel here)."""
    q = torch.empty(1, 4, 2, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention_fwd(q, q, q)
    with pytest.raises(ValueError, match="unsupported device"):
        sdpa_array(q, q, q, is_causal=True)
    with pytest.raises(ValueError, match="unsupported device"):
        sdpa_array(q, q, q, mask=torch.zeros(1, 1, 1, 4, device="meta"))
    with pytest.raises(NotImplementedError, match="_fwd_v1"):
        sdpa_array(q, q, q, mask=torch.ones(1, 1, 1, 4, dtype=torch.bool,
                                            device="meta"))
    with pytest.raises(NotImplementedError, match="broadcasts"):
        sdpa_array(q, q, q, mask=torch.zeros(1, 2, 4, 4, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        sdpa_array(q, q, q, dropout_p=0.1, seed_words=(1, 2))
    with pytest.raises(ValueError, match="unsupported device"):
        paged_decode_attention(
            torch.empty(1, 2, 64, device="meta"),
            torch.empty(3, 4, 2, 64, device="meta"),
            torch.empty(3, 4, 2, 64, device="meta"),
            torch.empty(1, 2, dtype=torch.int32, device="meta"),
            torch.empty(1, dtype=torch.int32, device="meta"), 0.125)


def test_cpu_calls_do_not_count_as_launches():
    kernels.reset_launch_counts()
    q, k, v = map(torch.from_numpy, _qkv(0, S=16))
    flash_attention_fwd(q, k, v)
    assert all(k["launches"] == 0 for k in kernels.kernels())


def test_registry_names_sources_and_tpu_kernels():
    rows = kernels.kernels()
    assert [r["name"] for r in rows] == [
        "flash_attention_fwd", "flash_attention_bwd", "chunked_ce_lse",
        "chunked_ce_dlogits", "fused_dropout", "paged_decode_attention",
        "flash_attention_bias_fwd", "flash_attention_bias_bwd_dq",
        "flash_attention_bias_bwd_dkv", "paged_decode_attention_quant",
        "bgmv", "int8_matmul"]
    for r in rows:
        assert (REPO / r["source"]).is_file()
        path, line = r["replaces"].split(":")
        text = (REPO / path).read_text().splitlines()[int(line) - 1]
        assert "pallas_call" in text, (r["replaces"], text)


# -- paged decode -------------------------------------------------------------
def _paged_inputs(seed, D=64, H=2, bs=4, MB=4, P=12):
    """Slots at different fill levels, a fresh slot at pos 0 and an
    inactive all-scratch row, as ``test_pallas_kernels._paged_state``."""
    rng = np.random.RandomState(seed)
    tbl = np.zeros((5, MB), np.int32)
    tbl[0, :3] = [1, 2, 3]
    tbl[1, :1] = [4]
    tbl[2, :4] = [6, 7, 8, 9]
    tbl[3, :1] = [10]                     # fresh slot, pos 0
    pos = np.array([9, 2, 14, 0, 0], np.int32)   # row 4: all scratch
    writes = []
    for b in range(4):
        n = int(pos[b]) + 1
        writes.append((b, rng.randn(1, n, H, D).astype(np.float32),
                       rng.randn(1, n, H, D).astype(np.float32)))
    q = rng.randn(5, H, D).astype(np.float32)
    return q, tbl, pos, writes, (P, bs, H, D)


def _fill(write, zeros, tbl, writes):
    kp, vp = zeros(), zeros()
    for b, kn, vn in writes:
        kp = write(kp, kn, tbl[b:b + 1])
        vp = write(vp, vn, tbl[b:b + 1])
    return kp, vp


def _jax_pools(tbl, writes, shape):
    import jax.numpy as jnp
    from paddle_tpu.serving.kv_cache import write_pages
    return _fill(lambda p, n, t: write_pages(p, jnp.asarray(n),
                                             jnp.asarray(t),
                                             jnp.zeros((1,), jnp.int32)),
                 lambda: jnp.zeros(shape, jnp.float32), tbl, writes)


def _torch_pools(tbl, writes, shape):
    return _fill(lambda p, n, t: tkv.write_pages(
        p, torch.from_numpy(n), torch.from_numpy(t),
        torch.zeros(1, dtype=torch.int32)),
        lambda: torch.zeros(shape), tbl, writes)


def test_paged_decode_matches_jax_kernel():
    import jax.numpy as jnp
    from paddle_tpu.ops.pallas.paged_decode import \
        paged_decode_attention as jax_paged_decode
    q, tbl, pos, writes, shape = _paged_inputs(0)
    scale = 1.0 / math.sqrt(shape[-1])
    jk, jv = _jax_pools(tbl, writes, shape)
    ref = np.asarray(jax_paged_decode(jnp.asarray(q), jk, jv,
                                      jnp.asarray(tbl), jnp.asarray(pos),
                                      scale=scale))
    tk, tv = _torch_pools(tbl, writes, shape)
    args = (torch.from_numpy(q), tk, tv, torch.from_numpy(tbl),
            torch.from_numpy(pos), scale)
    got = paged_decode_attention(*args)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(paged_decode_plain(*args).numpy(), ref,
                               rtol=1e-5, atol=1e-6)
    # the inactive row attends column 0 of scratch page 0 (zeros)
    assert np.all(got.numpy()[4] == 0.0)


def test_paged_decode_wrapper_checks_arguments():
    q = torch.zeros(2, 2, 64)
    pages = torch.zeros(3, 4, 2, 64)
    with pytest.raises(ValueError, match="do not hold"):
        paged_decode_attention(q, torch.zeros(3, 4, 2, 32),
                               torch.zeros(3, 4, 2, 32),
                               torch.zeros(2, 2, dtype=torch.int32),
                               torch.zeros(2, dtype=torch.int32), 0.1)
    with pytest.raises(ValueError, match="do not match"):
        paged_decode_attention(q, pages, pages,
                               torch.zeros(3, 2, dtype=torch.int32),
                               torch.zeros(2, dtype=torch.int32), 0.1)


# -- page scatter / gather ------------------------------------------------------
def test_write_and_gather_pages_bit_equal_to_jax():
    """Prefill-shaped writes (padded tails past MB*bs, an all-scratch
    padded row) then a decode-shaped write: every page except scratch
    page 0 is bit-equal, and so is the gathered context of live rows."""
    import jax.numpy as jnp
    from paddle_tpu.serving.kv_cache import gather_pages, write_pages
    rng = np.random.RandomState(1)
    P, bs, H, D, MB = 9, 4, 2, 8, 3
    tbl = np.array([[1, 2, 3], [4, 5, 0], [0, 0, 0]], np.int32)
    new = rng.randn(3, 16, H, D).astype(np.float32)     # 16 > MB*bs
    jp = write_pages(jnp.zeros((P, bs, H, D)), jnp.asarray(new),
                     jnp.asarray(tbl), jnp.zeros((3,), jnp.int32))
    tp = tkv.write_pages(torch.zeros(P, bs, H, D), torch.from_numpy(new),
                         torch.from_numpy(tbl),
                         torch.zeros(3, dtype=torch.int32))
    dec = rng.randn(3, 1, H, D).astype(np.float32)
    dpos = np.array([11, 5, 0], np.int32)
    jp = write_pages(jp, jnp.asarray(dec), jnp.asarray(tbl),
                     jnp.asarray(dpos))
    tp = tkv.write_pages(tp, torch.from_numpy(dec), torch.from_numpy(tbl),
                         torch.from_numpy(dpos))
    np.testing.assert_array_equal(tp.numpy()[1:], np.asarray(jp)[1:])
    live = tbl[:2]
    np.testing.assert_array_equal(
        tkv.gather_pages(tp, torch.from_numpy(live)).numpy()[:, :8],
        np.asarray(gather_pages(jp, jnp.asarray(live)))[:, :8])
    assert tkv.gather_pages(tp, torch.from_numpy(tbl)).shape == \
        (3, MB * bs, H, D)


# -- the kernels on the card ----------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no "
                    "CPU or interpreter mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("S,D", [(128, 64), (200, 64), (256, 128)])
def test_flash_kernel_matches_plain_on_card(cuda, dtype, tol, S, D):
    g = torch.Generator(device=cuda).manual_seed(S)
    q, k, v = (torch.randn(2, S, 4, D, device=cuda, generator=g).to(dtype)
               for _ in range(3))
    before = kernels.FLASH_ATTENTION_FWD.launches
    o, lse = flash_attention_fwd(q, k, v, causal=True, return_lse=True)
    assert kernels.FLASH_ATTENTION_FWD.launches == before + 1
    o_ref, lse_ref = flash_attention_plain(q, k, v, causal=True,
                                           return_lse=True)
    torch.cuda.synchronize()
    assert (o.float() - o_ref.float()).abs().max().item() <= tol
    assert (lse - lse_ref).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_paged_decode_kernel_matches_plain_on_card(cuda, dtype, tol):
    q, tbl, pos, writes, shape = _paged_inputs(2)
    kp, vp = _torch_pools(tbl, writes, shape)
    args = (torch.from_numpy(q).to(cuda, dtype), kp.to(cuda, dtype),
            vp.to(cuda, dtype), torch.from_numpy(tbl).to(cuda),
            torch.from_numpy(pos).to(cuda), 1.0 / math.sqrt(shape[-1]))
    before = kernels.PAGED_DECODE.launches
    got = paged_decode_attention(*args)
    assert kernels.PAGED_DECODE.launches == before + 1
    ref = paged_decode_plain(*args)
    torch.cuda.synchronize()
    assert (got.float() - ref.float()).abs().max().item() <= tol


# positions at the edges of the kernel's split of a slot over the blocks of
# its cluster (up to 8: fewer positions than blocks, one each, a page edge,
# the last position), then an inactive slot (pos 0, all-scratch row)
EDGE_POS = [0, 1, 7, 8, 63, 64, 200, 511, 0]


def _edge_table(pos, bs, MB, seed):
    """Block-table rows for slots at ``pos``, each slot's pages drawn
    from a permutation of pages 1..P-1, the last row all scratch page 0.
    Returns the table and P."""
    need = [int(p) // bs + 1 for p in pos[:-1]]
    P = sum(need) + 1
    perm = np.random.RandomState(seed).permutation(np.arange(1, P))
    tbl = np.zeros((len(pos), MB), np.int32)
    used = 0
    for b, n in enumerate(need):
        tbl[b, :n] = perm[used:used + n]
        used += n
    return tbl, P


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("D", [64, 128])
def test_paged_decode_cluster_split_edges_on_card(cuda, dtype, tol, D):
    """Every slot of :data:`EDGE_POS` within the kernel's tolerance of
    the plain version (random data on scratch page 0 too), and two
    launches give identical bits."""
    H, bs, MB = 2, 16, 32
    pos = np.array(EDGE_POS, np.int32)
    tbl, P = _edge_table(pos, bs, MB, seed=D)
    g = torch.Generator(device=cuda).manual_seed(D)
    kp, vp = (torch.randn(P, bs, H, D, device=cuda, generator=g).to(dtype)
              for _ in range(2))
    q = torch.randn(len(pos), H, D, device=cuda, generator=g).to(dtype)
    args = (q, kp, vp, torch.from_numpy(tbl).to(cuda),
            torch.from_numpy(pos).to(cuda), 1.0 / math.sqrt(D))
    before = kernels.PAGED_DECODE.launches
    got = paged_decode_attention(*args)
    again = paged_decode_attention(*args)
    assert kernels.PAGED_DECODE.launches == before + 2
    ref = paged_decode_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert (got.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.cuda
def test_cuda_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(1, 8, 2, 32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_fwd(q, q, q)
    with pytest.raises(NotImplementedError):
        sdpa_array(q, q, q, is_causal=True)
    q64 = torch.zeros(1, 8, 2, 64, device=cuda)
    with pytest.raises(NotImplementedError, match="boolean"):
        sdpa_array(q64, q64, q64, mask=torch.ones(1, 1, 1, 8,
                                                  dtype=torch.bool,
                                                  device=cuda))
    q64 = torch.zeros(1, 8, 2, 64, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_fwd(q64.transpose(1, 2).contiguous().transpose(1, 2),
                            q64, q64)
