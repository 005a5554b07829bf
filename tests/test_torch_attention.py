"""Port attention ops vs the JAX package's kernels (CPU, f32).

The same numpy inputs, made from a seed, go through the JAX function (its
Pallas kernel in interpret mode, as the JAX package's own tests run it)
and through the port's plain PyTorch version of the CUDA kernel (what the
port's wrappers run on CPU tensors). Tolerance: atol 1e-5 in f32 — the
same math summed in another order (the JAX kernels tile the KV axis, the
plain versions reduce it at once).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ray_dynamic_batching_tpu.ops import attention as j_attention
from ray_dynamic_batching_tpu.ops import decode_attention as j_decode
from ray_dynamic_batching_tpu.ops import flash_attention as j_flash
from ray_dynamic_batching_tpu_torch.ops import attention as t_attention
from ray_dynamic_batching_tpu_torch.ops import decode_attention as t_decode
from ray_dynamic_batching_tpu_torch.ops import flash_attention as t_flash

torch.set_num_threads(2)

ATOL = 1e-5


def _qkv(rng, B, Tq, Tk, N, K, H):
    q = rng.standard_normal((B, Tq, N, H)).astype(np.float32)
    k = rng.standard_normal((B, Tk, K, H)).astype(np.float32)
    v = rng.standard_normal((B, Tk, K, H)).astype(np.float32)
    return q, k, v


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


class TestFlashPlainVsJaxKernel:
    @pytest.mark.parametrize("causal,N,K,Tq,Tk", [
        (True, 4, 4, 32, 32),     # causal, MHA
        (True, 4, 2, 16, 48),     # causal GQA, Tq < Tk (diagonal offset)
        (False, 8, 2, 32, 64),    # non-causal GQA, no mask
    ])
    def test_matches(self, causal, N, K, Tq, Tk):
        rng = np.random.default_rng(0)
        q, k, v = _qkv(rng, 2, Tq, Tk, N, K, 32)
        want = j_flash.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            interpret=True)
        got = t_flash.flash_attention(_t(q), _t(k), _t(v), causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)

    def test_int8_mask_and_fully_masked_rows_give_zero(self):
        rng = np.random.default_rng(1)
        B, Tq, Tk, N, K, H = 2, 16, 64, 4, 2, 32
        q, k, v = _qkv(rng, B, Tq, Tk, N, K, H)
        mask = rng.random((B, 1, Tq, Tk)) < 0.6
        mask[0, 0, 3, :] = False      # fully masked rows
        mask[1, 0, 10, :] = False
        want = np.asarray(j_flash.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            mask=jnp.asarray(mask), interpret=True))
        got = t_flash.flash_attention(_t(q), _t(k), _t(v),
                                      mask=_t(mask)).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL)
        assert np.all(got[0, 3] == 0.0) and np.all(got[1, 10] == 0.0)
        assert np.all(want[0, 3] == 0.0)

    def test_prefill_mask_over_padded_capacity(self):
        """The serving shape: a causal prefill mask over a row cache wider
        than the prompt (padding beyond T is False)."""
        rng = np.random.default_rng(2)
        B, T, S, N, K, H = 2, 16, 64, 4, 2, 32
        q, k, v = _qkv(rng, B, T, S, N, K, H)
        lengths = np.array([11, 16])
        causal = np.tril(np.ones((T, T), bool))
        valid = np.arange(T)[None, :] < lengths[:, None]
        base = causal[None, None] & valid[:, None, None, :]
        mask = np.concatenate([base, np.zeros((B, 1, T, S - T), bool)], -1)
        want = j_flash.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            mask=jnp.asarray(mask), interpret=True)
        got = t_flash.flash_attention(_t(q), _t(k), _t(v), mask=_t(mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


class TestDecodePlainVsJaxKernel:
    @pytest.mark.parametrize("Tq", [1, 2, 3, 4, 5, 6, 7, 8])
    @pytest.mark.parametrize("N,K", [(4, 4), (8, 2)])   # MHA, GQA
    def test_window_mask_multi_tile(self, Tq, N, K):
        """S = 256 scanned in two 128-wide tiles by the JAX kernel
        (block_k=128) against the plain version's one-shot softmax."""
        rng = np.random.default_rng(Tq * 10 + N)
        B, S, H = 2, 256, 32
        q, k, v = _qkv(rng, B, Tq, S, N, K, H)
        lengths = rng.integers(1, S - Tq, size=B)
        mask = (np.arange(S)[None, None, None, :]
                <= (lengths[:, None] + np.arange(Tq)[None, :])[:, None, :,
                                                                None])
        want = j_decode.decode_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            mask=jnp.asarray(mask), block_k=128, interpret=True)
        got = t_decode.decode_attention(_t(q), _t(k), _t(v), mask=_t(mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)

    def test_no_mask_and_fully_masked_row(self):
        rng = np.random.default_rng(3)
        B, Tq, S, N, K, H = 2, 1, 128, 8, 2, 32
        q, k, v = _qkv(rng, B, Tq, S, N, K, H)
        want = j_decode.decode_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True)
        got = t_decode.decode_attention(_t(q), _t(k), _t(v))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
        # A row with no attended key averages V in both (reference rule).
        mask = np.ones((B, 1, Tq, S), bool)
        mask[1] = False
        want = j_decode.decode_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            mask=jnp.asarray(mask), interpret=True)
        got = t_decode.decode_attention(_t(q), _t(k), _t(v), mask=_t(mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)

    def test_refuses_what_it_does_not_take(self):
        q = torch.zeros((1, 9, 4, 32))
        k = torch.zeros((1, 64, 2, 32))
        with pytest.raises(ValueError, match="window"):
            t_decode.decode_attention(q, k, k)   # Tq > 8: route says plain
        # Scales come in pairs, with int8 codes, in k's shape minus H.
        q1 = q[:, :1]
        codes = k.to(torch.int8)
        with pytest.raises(ValueError, match="both"):
            t_decode.decode_attention(q1, codes, codes,
                                      k_scale=torch.ones((1, 64, 2)))
        with pytest.raises(TypeError, match="int8 codes"):
            t_decode.decode_attention(q1, k, k,
                                      k_scale=torch.ones((1, 64, 2)),
                                      v_scale=torch.ones((1, 64, 2)))
        with pytest.raises(ValueError, match="scale planes"):
            t_decode.decode_attention(q1, codes, codes,
                                      k_scale=torch.ones((1, 2, 64)),
                                      v_scale=torch.ones((1, 2, 64)))


# (Tq, causal, mask kind) -> the route the JAX dispatcher takes on its
# Pallas branch; "window" = [B, 1, Tq, S], "head" = per-head [B, N, Tq, S].
ROUTE_CASES = [
    (1, False, "window"), (4, False, None), (8, False, "window"),
    (12, False, "window"), (16, False, "window"), (32, True, None),
    (4, True, None), (1, False, "head"),
]


class TestDispatcherRule:
    @pytest.mark.parametrize("Tq,causal,mask_kind", ROUTE_CASES)
    def test_route_and_output_match_reference(self, Tq, causal, mask_kind,
                                              monkeypatch):
        rng = np.random.default_rng(Tq)
        B, S, N, K, H = 2, 128, 4, 2, 32
        q, k, v = _qkv(rng, B, Tq, S, N, K, H)
        mask = None
        if mask_kind == "window":
            mask = rng.random((B, 1, Tq, S)) < 0.7
            mask[..., 0] = True
        elif mask_kind == "head":
            mask = rng.random((B, N, Tq, S)) < 0.7
            mask[..., 0] = True
        taken = []

        def spy(name, fn):
            def wrapped(*a, **kw):
                kw.setdefault("interpret", True)
                out = fn(*a, **kw)
                if out is not None:
                    taken.append(name)
                return out
            return wrapped

        monkeypatch.setattr(j_decode, "decode_attention",
                            spy("decode", j_decode.decode_attention))
        monkeypatch.setattr(j_flash, "flash_attention",
                            spy("flash", j_flash.flash_attention))
        j_attention.set_attention_backend("pallas")
        try:
            want = j_attention.dot_product_attention(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                causal=causal,
                mask=None if mask is None else jnp.asarray(mask))
        finally:
            j_attention.set_attention_backend("auto")
        jax_route = taken[0] if taken else "plain"
        port_route = t_attention.route(
            q.shape, k.shape, causal=causal,
            mask_shape=None if mask is None else mask.shape)
        assert port_route == jax_route
        before = t_attention.plain_launches
        got = t_attention.dot_product_attention(
            _t(q), _t(k), _t(v), causal=causal,
            mask=None if mask is None else _t(mask))
        assert (t_attention.plain_launches - before) == (
            1 if port_route == "plain" else 0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)

    @pytest.mark.parametrize("Tq", [1, 12, 16])   # decode, plain, flash
    def test_int8_keep_mask_from_kernel_mask(self, Tq):
        """The model makes the int8 keep-mask once per forward: every route
        gives on it what it gives on the boolean mask, and the kernels'
        wrappers take it as it is (no copy)."""
        rng = np.random.default_rng(Tq)
        B, S, N, K, H = 2, 128, 4, 2, 32
        q, k, v = _qkv(rng, B, Tq, S, N, K, H)
        mask = _t(rng.random((B, 1, Tq, S)) < 0.7)
        keep = t_attention.kernel_mask(mask, B, Tq)
        assert keep.dtype == torch.int8 and tuple(keep.shape) == (B, 1, Tq, S)
        assert t_flash.keep_mask(keep, B, Tq, S).data_ptr() == keep.data_ptr()
        want = t_attention.dot_product_attention(_t(q), _t(k), _t(v),
                                                 mask=mask)
        got = t_attention.dot_product_attention(_t(q), _t(k), _t(v),
                                                mask=keep)
        assert torch.equal(got, want)

    def test_reference_attention_matches_xla_path(self):
        rng = np.random.default_rng(9)
        q, k, v = _qkv(rng, 2, 12, 40, 8, 2, 16)
        mask = rng.random((2, 1, 12, 40)) < 0.5
        mask[1, 0, 4] = False    # a fully masked row averages V
        want = j_attention._xla_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
            mask=jnp.asarray(mask), scale=None)
        got = t_attention.reference_attention(
            _t(q), _t(k), _t(v), causal=True, mask=_t(mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def _paged_inputs(rng, B, Tq, N, K, H, P, ps, NP, lengths):
    """Pools [P, ps, K, H], a shuffled table whose entries past each
    slot's length + window are the sentinel P, and q."""
    q = rng.standard_normal((B, Tq, N, H)).astype(np.float32)
    k = rng.standard_normal((P, ps, K, H)).astype(np.float32)
    v = rng.standard_normal((P, ps, K, H)).astype(np.float32)
    perm = rng.permutation(P)
    table = np.full((B, NP), P, np.int32)
    used = 0
    for b in range(B):
        n = -(-(int(lengths[b]) + Tq) // ps)
        table[b, :n] = perm[used: used + n]
        used += n
    return q, k, v, table, np.asarray(lengths, np.int32)


class TestHeadDimRule:
    """The decode kernels take head dims that are multiples of 16 up to
    128 (smaller ones zero-padded in shared memory on the card); a small
    window of any other head dim takes the plain route, decided by shape
    before launch and counted in ``plain_launches``, and gives the JAX
    package's output (its kernel has no head-dim rule; on the CPU its
    dispatcher runs XLA)."""

    @pytest.mark.parametrize("H", [8, 16, 24, 48, 64, 80, 104, 128, 136])
    def test_route_by_head_dim(self, H):
        ok = H % 16 == 0 and H <= 128
        assert t_decode.head_dim_ok(H) == ok
        assert t_attention.route((2, 1, 4, H), (2, 64, 2, H), causal=False,
                                 mask_shape=(2, 1, 1, 64)) == (
            "decode" if ok else "plain")
        assert t_attention.route((2, 1, 4, H), (8, 128, 2, H), causal=False,
                                 page_table_shape=(2, 2),
                                 lengths_shape=(2,)) == (
            "paged_decode" if ok else "plain")

    def test_refused_head_dim_takes_the_plain_route(self):
        rng = np.random.default_rng(24)
        q, k, v = _qkv(rng, 2, 3, 40, 4, 2, 24)
        mask = np.ones((2, 1, 3, 40), bool)
        mask[1, :, :, 30:] = False
        t_attention.reset_counts()
        got = t_attention.dot_product_attention(_t(q), _t(k), _t(v),
                                                mask=torch.from_numpy(mask))
        assert t_attention.plain_launches == 1
        want = j_attention.dot_product_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            mask=jnp.asarray(mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


class TestPagedPlainVsJaxKernel:
    @pytest.mark.parametrize("Tq", [1, 2, 3, 4, 5, 6, 7, 8])
    @pytest.mark.parametrize("N,K", [(4, 4), (8, 2)])   # MHA, GQA
    def test_staircase_sentinels_shuffled_pool(self, Tq, N, K):
        """ps = 128, 3 table entries per slot; one slot holds a single
        allocated page (the rest sentinel), the others span two or three
        pages of a shuffled pool."""
        rng = np.random.default_rng(100 + Tq * 10 + N)
        B, H, ps, NP = 3, 32, 128, 3
        lengths = [5, 200, 380 - Tq]
        q, k, v, table, lens = _paged_inputs(rng, B, Tq, N, K, H, 8, ps, NP,
                                             lengths)
        assert (table[0] == 8).sum() == 2        # one page, two sentinels
        want = j_decode.paged_decode_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(table), jnp.asarray(lens), interpret=True)
        got = t_decode.paged_decode_attention(_t(q), _t(k), _t(v), _t(table),
                                              _t(lens))
        assert t_attention.route(q.shape, k.shape, causal=False,
                                 page_table_shape=table.shape,
                                 lengths_shape=lens.shape) == "paged_decode"
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)

    def test_plain_version_is_the_gathered_slab_rule(self):
        """The plain version equals the slab plain version over the
        gathered view with the staircase mask (the reference's fallback)."""
        rng = np.random.default_rng(7)
        q, k, v, table, lens = _paged_inputs(rng, 2, 4, 8, 2, 32, 6, 128, 2,
                                             [10, 130])
        got = t_decode.paged_decode_attention_plain(
            _t(q), _t(k), _t(v), _t(table), _t(lens))
        want = j_attention._paged_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(table), jnp.asarray(lens), mask=None, scale=None,
            k_scale=None, v_scale=None)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)

    def test_refuses_what_it_does_not_take(self):
        q = torch.zeros((1, 1, 4, 32))
        pool = torch.zeros((4, 128, 2, 32))
        table = torch.zeros((1, 2), dtype=torch.int32)
        lens = torch.zeros((1,), dtype=torch.int32)
        with pytest.raises(TypeError, match="int8 codes"):
            t_decode.paged_decode_attention(
                q, pool, pool, table, lens,
                k_scale=torch.ones((4, 128, 2)),
                v_scale=torch.ones((4, 128, 2)))
        codes = pool.to(torch.int8)
        with pytest.raises(ValueError, match="both"):
            t_decode.paged_decode_attention(
                q, codes, codes, table, lens, v_scale=torch.ones((4, 128, 2)))
        with pytest.raises(ValueError, match="paged decode pattern"):
            t_decode.paged_decode_attention(torch.zeros((1, 9, 4, 32)), pool,
                                            pool, table, lens)
        with pytest.raises(ValueError, match="explicit mask"):
            t_attention.dot_product_attention(
                q, pool, pool, mask=torch.ones((1, 1, 1, 256), dtype=bool),
                page_table=table, kv_lengths=lens)


# (window W, page size) -> the route the JAX dispatcher takes on its
# Pallas branch for a paged call: its paged kernel, or (declined) the
# gather re-entry into the slab rule.
PAGED_ROUTE_CASES = [(1, 128), (8, 128), (12, 128), (16, 128), (32, 128),
                     (1, 64)]


class TestPagedDispatcherRule:
    @pytest.mark.parametrize("W,ps", PAGED_ROUTE_CASES)
    def test_route_and_output_match_reference(self, W, ps, monkeypatch):
        rng = np.random.default_rng(W + ps)
        B, N, K, H, NP = 2, 4, 2, 32, 2
        q, k, v, table, lens = _paged_inputs(rng, B, W, N, K, H, 5, ps, NP,
                                             [3, ps - W + 5])
        taken = []

        def spy(name, fn):
            def wrapped(*a, **kw):
                kw.setdefault("interpret", True)
                out = fn(*a, **kw)
                if out is not None:
                    taken.append(name)
                return out
            return wrapped

        monkeypatch.setattr(j_decode, "paged_decode_attention",
                            spy("paged_decode",
                                j_decode.paged_decode_attention))
        monkeypatch.setattr(j_decode, "decode_attention",
                            spy("decode", j_decode.decode_attention))
        monkeypatch.setattr(j_flash, "flash_attention",
                            spy("flash", j_flash.flash_attention))
        j_attention.set_attention_backend("pallas")
        try:
            want = j_attention.dot_product_attention(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                page_table=jnp.asarray(table), kv_lengths=jnp.asarray(lens))
        finally:
            j_attention.set_attention_backend("auto")
        jax_route = taken[0] if taken else "plain"
        port_route = t_attention.route(
            q.shape, k.shape, causal=False, page_table_shape=table.shape,
            lengths_shape=lens.shape)
        assert port_route == jax_route
        assert port_route == {1: "paged_decode", 8: "paged_decode",
                              12: "plain", 16: "flash", 32: "flash"}[W] \
            or ps != 128
        before = t_attention.plain_launches
        got = t_attention.dot_product_attention(
            _t(q), _t(k), _t(v), page_table=_t(table), kv_lengths=_t(lens))
        assert (t_attention.plain_launches - before) == (
            1 if port_route == "plain" else 0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)

    def test_reset_counts_zeroes_the_paged_counter(self):
        t_decode.paged_launches = 5
        t_attention.reset_counts()
        assert t_decode.paged_launches == 0

    def test_reset_counts_zeroes_the_launches_by_body(self):
        """Each kernel's launches by body are launch counts like the rest:
        zeroed in place (a captured graph's record keeps adding to the
        same dicts)."""
        by_body = (t_flash.launches_by_body, t_decode.launches_by_body)
        for counts in by_body:
            for body in counts:
                counts[body] = 3
        t_attention.reset_counts()
        assert t_flash.launches_by_body is by_body[0]
        assert t_decode.launches_by_body is by_body[1]
        assert all(n == 0 for counts in by_body for n in counts.values())

    def test_plain_attention_covers_the_paged_kernel(self):
        rng = np.random.default_rng(11)
        q, k, v, table, lens = _paged_inputs(rng, 2, 1, 4, 2, 32, 4, 128, 2,
                                             [40, 150])
        with t_attention.plain_attention():
            got = t_attention.dot_product_attention(
                _t(q), _t(k), _t(v), page_table=_t(table),
                kv_lengths=_t(lens))
        want = t_decode.paged_decode_attention_plain(
            _t(q), _t(k), _t(v), _t(table), _t(lens))
        assert torch.equal(got, want)


class TestKeepMaskLayout:
    """``keep_mask``'s layouts (what kernels 1 and 2 read through a batch
    and a row stride): a key row of row stride 0, rows padded to 16 bytes,
    the dense contiguous layout where Tk % 16 == 0 — and the plain
    versions give the same values on every one of them."""

    @staticmethod
    def _storage(t):
        return torch.tensor(t.untyped_storage().tolist(), dtype=torch.uint8)

    @pytest.mark.parametrize("B,Tq,Tk", [(3, 130, 150), (2, 16, 64),
                                         (4, 1, 1500)])
    def test_key_rows(self, B, Tq, Tk):
        rng = np.random.default_rng(Tk)
        n = rng.integers(1, Tk + 1, B)
        key = _t(np.arange(Tk)[None, :] < n[:, None])[:, None, None]
        keep = t_flash.keep_mask(key, B, Tq, Tk)
        assert keep.dtype == torch.int8 and tuple(keep.shape) == (B, Tq, Tk)
        pad = -(-Tk // 16) * 16
        bs, rs = t_flash.mask_strides(keep)
        assert rs == 0 and bs in (0, pad)
        assert torch.equal(keep.bool(), key[:, 0].expand(B, Tq, Tk))
        # The padding past Tk in each row is zero.
        rows = self._storage(keep).reshape(-1, pad)
        assert rows[:, Tk:].sum().item() == 0
        # A layout already right comes back as it is; so does its [B, 1, ...]
        # view (what a model hands every layer).
        again = t_flash.keep_mask(keep[:, None], B, Tq, Tk)
        assert again.data_ptr() == keep.data_ptr()
        assert again.stride() == keep.stride()

    def test_batch_broadcast_key_row(self):
        key = _t(np.arange(40) < 25)[None, None, None]       # [1, 1, 1, 40]
        keep = t_flash.keep_mask(key, 3, 20, 40)
        assert keep.stride(1) == 0 and keep.stride(0) == 48
        assert torch.equal(keep.bool(), key[0, 0].expand(3, 20, 40))

    def test_padded_dense_rows(self):
        rng = np.random.default_rng(3)
        B, Tq, Tk = 2, 24, 150
        mask = _t(rng.random((B, 1, Tq, Tk)) < 0.5)
        keep = t_flash.keep_mask(mask, B, Tq, Tk)
        assert t_flash.mask_strides(keep) == (Tq * 160, 160)
        assert torch.equal(keep.bool(), mask[:, 0])
        rows = self._storage(keep).reshape(-1, 160)
        assert rows[:, Tk:].sum().item() == 0

    def test_aligned_dense_layout_is_unchanged(self):
        """Tk % 16 == 0 and a mask that varies over the rows: the dense
        contiguous int8 tensor, exactly the layout before key rows."""
        rng = np.random.default_rng(4)
        mask = _t(rng.random((2, 1, 8, 512)) < 0.5)
        keep = t_flash.keep_mask(mask, 2, 8, 512)
        assert keep.is_contiguous()
        assert torch.equal(keep, mask.reshape(2, 8, 512).to(torch.int8))
        assert t_flash.mask_strides(keep) == (8 * 512, 512)

    def test_mask_strides_refuses_other_layouts(self):
        m = torch.zeros((2, 4, 40), dtype=torch.int8)
        assert t_flash.mask_strides(m) is None                 # rows 40 apart
        assert t_flash.mask_strides(m.float()) is None
        assert t_flash.mask_strides(torch.zeros((2, 4, 48),
                                                dtype=torch.int8)[..., :40]) \
            == (192, 48)
        assert t_flash.mask_strides(torch.zeros((2, 4, 32),
                                                dtype=torch.int8)[..., 1:31]) \
            is None                                            # unaligned

    @pytest.mark.parametrize("case", ["key_row_of_one", "single_row",
                                      "dense_short_storage"])
    def test_mask_strides_refuses_rows_short_of_their_last_chunk(self, case):
        """The kernels read each row to ``ceil(Tk / 16) * 16`` bytes: a view
        whose storage ends before that is refused, and ``keep_mask`` copies
        it into the padded layout, the same values."""
        Tk = 40
        base = torch.from_numpy(
            np.random.default_rng(len(case)).random(2 * 4 * 48) < 0.5
        ).to(torch.int8)
        if case == "key_row_of_one":        # one int8 key row, expanded
            B, Tq = 1, 20
            m = base[:Tk].clone().view(1, 1, Tk).expand(B, Tq, Tk)
            roomy = base[:Tk].view(1, 1, Tk).expand(B, Tq, Tk)
        elif case == "single_row":
            B, Tq = 1, 1
            m, roomy = base[:Tk].clone().view(1, 1, Tk), base[:Tk].view(1, 1, Tk)
        else:                               # 8 bytes short of the last chunk
            B, Tq = 2, 4
            m = base[:-8].clone().as_strided((B, Tq, Tk), (192, 48, 1))
            roomy = base.as_strided((B, Tq, Tk), (192, 48, 1))
        assert t_flash.mask_strides(m) is None
        keep = t_flash.keep_mask(m[:, None], B, Tq, Tk)
        assert t_flash.mask_strides(keep) is not None
        assert keep.data_ptr() != m.data_ptr()
        assert torch.equal(keep, m)
        # The same view over storage that holds the chunk: read in place.
        assert t_flash.mask_strides(roomy) is not None
        assert t_flash.keep_mask(roomy[:, None], B, Tq, Tk).data_ptr() \
            == roomy.data_ptr()

    @pytest.mark.parametrize("kind", ["key", "dense_padded", "dense"])
    def test_plain_versions_equal_on_every_layout(self, kind):
        rng = np.random.default_rng(len(kind))
        B, Tq, N, K, H = 2, 20, 4, 2, 16
        Tk = 64 if kind == "dense" else 150
        q, k, v = _qkv(rng, B, Tq, Tk, N, K, H)
        if kind == "key":
            mask = _t(np.arange(Tk)[None, :]
                      < np.array([Tk, 70])[:, None])[:, None, None]
        else:
            mask = _t(rng.random((B, 1, Tq, Tk)) < 0.6)
        keep = t_flash.keep_mask(mask, B, Tq, Tk)
        dense = mask.expand(B, 1, Tq, Tk)[:, 0].to(torch.int8).contiguous()
        for causal in (False, True):
            assert torch.equal(
                t_flash.flash_attention_plain(_t(q), _t(k), _t(v), keep,
                                              causal=causal),
                t_flash.flash_attention_plain(_t(q), _t(k), _t(v), dense,
                                              causal=causal))
        q1 = _t(q[:, :1])
        keep1 = t_flash.keep_mask(mask[:, :, :1], B, 1, Tk)
        assert torch.equal(
            t_decode.decode_attention_plain(q1, _t(k), _t(v), keep1),
            t_decode.decode_attention_plain(q1, _t(k), _t(v),
                                            dense[:, :1].contiguous()))


class TestKernelBodyRule:
    """The body kernels 2 and 3 pick by shape (``decode_attention.body_for``;
    kernel 1's rule lives in its library and is held on the card); the
    card tests check each launch reports the body named here."""

    @pytest.mark.parametrize("Tq,N,K,want", [
        (1, 20, 20, "row"), (1, 16, 16, "row"), (1, 32, 8, "scan"),
        (5, 16, 16, "scan"), (2, 4, 4, "scan")])
    def test_decode_bodies(self, Tq, N, K, want):
        assert t_decode.body_for(Tq, N, K) == want
