"""The port's Whisper-style ASR (``models/asr.py``) against the JAX
package's, on the CPU in f32 — the twins of ``tests/test_asr.py`` and
``tests/test_asr_serving.py``.

``whisper_tiny_test`` from flax params (``init(PRNGKey(0))``) converted by
``models/convert.asr_params_from_flax``; numpy mel features and tokens
from a seed. Tolerance: atol 1e-5 on f32 logits (the same math in another
summation order; the encoder states within 2e-5), identical greedy
tokens and transcripts. Covered: duration buckets, ragged collation,
empty and overflowing batches raising, ``collate_asr`` and
``collate_audio`` batches equal to the reference's, ``apply`` / ``encode``
/ ``prefill`` / ``decode_step`` against JAX, padding invariance,
prefill + decode against teacher forcing, the decode step's write at
capacity dropped, chunked streaming (transcripts equal to the JAX
``StreamingASR``'s), and a served roundtrip controller -> router ->
replica -> ``StreamingASR`` on the port's controller, each transcript
equal to a direct run. Every test that serves joins what it started and
has its own timeout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_dynamic_batching_tpu.engine import collate as j_collate
from ray_dynamic_batching_tpu.engine.request import Request as JRequest
from ray_dynamic_batching_tpu.models import asr as j_asr
from ray_dynamic_batching_tpu.models import registry as j_reg
from ray_dynamic_batching_tpu_torch.engine import collate as t_collate
from ray_dynamic_batching_tpu_torch.engine.request import Request
from ray_dynamic_batching_tpu_torch.models import asr as t_asr
from ray_dynamic_batching_tpu_torch.models import convert
from ray_dynamic_batching_tpu_torch.models import registry as t_reg

torch.set_num_threads(2)

ATOL = 1e-5


def _port_model(params):
    tm = t_reg.get_model("whisper_tiny_test", dtype=torch.float32,
                         device="cpu", seed=None)
    tm.load_state_dict(convert.asr_params_from_flax(params))
    return tm.eval()


@pytest.fixture(scope="module")
def pair():
    """(JAX model, its numpy params, the port model with those weights)."""
    jm = j_reg.get_model("whisper_tiny_test", dtype=jnp.float32)
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.init(jax.random.PRNGKey(0)))
    return jm, params, _port_model(params)


def _mel(rng, t, n_mels=16):
    return rng.standard_normal((t, n_mels)).astype(np.float32)


def _t(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


class TestRaggedBatching:
    def test_bucket_frames(self):
        for n in (1, 200, 201, 999, 1500, 2999, 3000, 10_000):
            assert t_asr.bucket_frames(n) == j_asr.bucket_frames(n)
        assert t_asr.AUDIO_BUCKETS == j_asr.AUDIO_BUCKETS
        assert t_asr.bucket_frames(201) == 500

    def test_collate_ragged(self):
        rng = np.random.default_rng(0)
        mels = [_mel(rng, 120), _mel(rng, 40)]
        mel, mask = t_asr.collate_audio(mels, batch_bucket=4)
        j_mel, j_mask = j_asr.collate_audio(mels, batch_bucket=4)
        np.testing.assert_array_equal(mel, j_mel)
        np.testing.assert_array_equal(mask, j_mask)
        assert mel.shape == (4, 200, 16) and mask.dtype == np.int32
        assert mask[0].sum() == 120 and mask[1].sum() == 40
        assert mask[2].sum() == 0

    def test_collate_empty_raises(self):
        with pytest.raises(ValueError, match="empty"):
            t_asr.collate_audio([], 4)

    def test_collate_overflow_raises(self):
        rng = np.random.default_rng(9)
        with pytest.raises(ValueError, match="exceed"):
            t_asr.collate_audio([_mel(rng, 10)] * 5, batch_bucket=4)

    def test_engine_collate_asr_equals_the_reference(self, pair):
        """``collate`` serves the asr family: (mel, mask, SOT prompt,
        prompt mask) with one valid frame in padding rows, equal to the
        reference's, and logits of them equal to the JAX model's."""
        jm, params, tm = pair
        rng = np.random.default_rng(10)
        clips = [_mel(rng, t) for t in (80, 150)]
        j_in, jn = j_collate.collate(
            jm, [JRequest("whisper_tiny_test", c, slo_ms=4000)
                 for c in clips], batch_bucket=4)
        t_in, n = t_collate.collate(
            tm, [Request(model="whisper_tiny_test", payload=c, slo_ms=4000)
                 for c in clips], batch_bucket=4)
        assert n == jn == 2
        for got, want in zip(t_in, j_in):
            assert got.dtype == torch.from_numpy(np.asarray(want)).dtype
            np.testing.assert_array_equal(got.numpy(), want)
        assert t_in[1][2:, 0].tolist() == [1, 1]
        want = np.asarray(jm.apply(params, *j_in))
        with torch.inference_mode():
            got = tm(*t_in).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


class TestForward:
    def test_teacher_forced_logits_match_jax(self, pair):
        jm, params, tm = pair
        rng = np.random.default_rng(1)
        mel, mask = t_asr.collate_audio([_mel(rng, 150), _mel(rng, 60)], 2)
        tokens = rng.integers(0, 256, (2, 16)).astype(np.int32)
        tmask = np.ones((2, 16), np.int32)
        tmask[1, 10:] = 0
        want = np.asarray(jm.apply(params, mel, mask, tokens, tmask))
        with torch.inference_mode():
            got = tm.apply(*_t(mel, mask, tokens, tmask)).numpy()
        assert got.shape == (2, 16, 256)
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
        assert (got.argmax(-1) == want.argmax(-1)).all()

    def test_encode_matches_jax(self, pair):
        jm, params, tm = pair
        rng = np.random.default_rng(11)
        mel, mask = t_asr.collate_audio([_mel(rng, 181), _mel(rng, 33)], 3)
        states, smask = jm.encode(params, mel, mask)
        with torch.inference_mode():
            t_states, t_smask = tm.encode(*_t(mel, mask))
        assert tuple(t_states.shape) == states.shape == (3, 100, 64)
        np.testing.assert_array_equal(t_smask.numpy(), np.asarray(smask))
        # Row 2 has no valid frame (collate_asr never sends one: its
        # padding rows keep frame 0). There the flash route gives 0, as
        # the reference's Pallas kernel does, and the reference's XLA
        # route on the CPU the mean of V; only the real rows compare.
        np.testing.assert_allclose(t_states[:2].numpy(),
                                   np.asarray(states)[:2], rtol=0, atol=2e-5)
        assert torch.isfinite(t_states).all()

    def test_padding_invariance(self, pair):
        """A clip padded into a larger bucket gives the logits of the same
        clip in a tight bucket (ragged masking)."""
        _, _, tm = pair
        rng = np.random.default_rng(2)
        clip = _mel(rng, 180)
        mel_a, mask_a = t_asr.collate_audio([clip], 1, buckets=(200,))
        mel_b, mask_b = t_asr.collate_audio([clip], 1, buckets=(500,))
        tokens = rng.integers(0, 256, (1, 8)).astype(np.int32)
        tmask = np.ones((1, 8), np.int32)
        with torch.inference_mode():
            la = tm.apply(*_t(mel_a, mask_a, tokens, tmask))
            lb = tm.apply(*_t(mel_b, mask_b, tokens, tmask))
        np.testing.assert_allclose(la.numpy(), lb.numpy(), atol=2e-4,
                                   rtol=1e-4)

    def test_full_width_counts_and_flops(self):
        jm = j_reg.get_model("whisper_large_v3")
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
        j_count = sum(int(np.prod(leaf.shape))
                      for leaf in jax.tree_util.tree_leaves(shapes))
        tm = t_reg.get_model("whisper_large_v3", device="meta", seed=None)
        assert tm.param_count() == j_count
        assert tm.cfg.n_mels == jm.cfg.n_mels == 80
        for seq in (None, 1500, 3000):
            assert tm.flops_per_sample(seq) == jm.flops_per_sample(seq)
        assert [tuple(x.shape) for x in tm.example_inputs(2, 8)] == [
            x.shape for x in jm.example_inputs(2, 8)]
        assert tm.family == "asr"
        assert t_reg.get_slo("whisper_large_v3").latency_slo_ms == 4000.0


class TestDecode:
    def test_prefill_and_steps_match_jax(self, pair):
        """prefill + three greedy steps on both packages: logits within
        the tolerance, identical tokens; the port's cross K/V are made
        once, at prefill."""
        jm, params, tm = pair
        rng = np.random.default_rng(3)
        mel, mask = t_asr.collate_audio([_mel(rng, 100), _mel(rng, 190)], 2)
        enc, emask = jm.encode(params, mel, mask)
        tokens = np.zeros((2, 16), np.int32)
        tokens[:, 0] = 254
        tokens[0, 1:3] = (5, 9)
        tmask = (np.arange(16)[None, :] < np.array([[3], [1]])).astype(
            np.int32)
        cache = jm.make_cache(2, max_len=32)
        jl, cache = jm.prefill(params, tokens, tmask, enc, emask, cache)
        with torch.inference_mode():
            t_enc, t_emask = tm.encode(*_t(mel, mask))
            tc = tm.make_cache(2, max_len=32)
            tl, tc = tm.prefill(*_t(tokens, tmask), t_enc, t_emask, tc)
            cross = tc.cross_k
            assert cross is not None and tuple(cross.shape) == (
                2, 2, 100, 4, 16)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                       atol=ATOL)
            for _ in range(3):
                nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
                assert (tl.numpy().argmax(-1) == nxt).all()
                jl, cache = jm.decode_step(params, nxt[:, None], enc, emask,
                                           cache, jnp.ones((2,), bool))
                tl, tc = tm.decode_step(torch.from_numpy(nxt[:, None]),
                                        t_enc, t_emask, tc,
                                        torch.ones(2, dtype=torch.bool))
                np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                           rtol=0, atol=ATOL)
            assert tc.cross_k is cross     # reused, not re-projected
            np.testing.assert_array_equal(tc.lengths.numpy(),
                                          np.asarray(cache.lengths))

    def test_prefill_decode_matches_teacher_forcing(self, pair):
        """A greedy continuation through the cache equals the argmax of
        teacher-forced logits computed without one."""
        _, _, tm = pair
        rng = np.random.default_rng(3)
        mel, mask = _t(*t_asr.collate_audio([_mel(rng, 100)], 1))
        prompt = [254, 5, 9]
        T = 8
        tokens = torch.zeros((1, T), dtype=torch.int32)
        tokens[0, :3] = torch.tensor(prompt)
        tmask = torch.zeros((1, T), dtype=torch.int32)
        tmask[0, :3] = 1
        with torch.inference_mode():
            enc, emask = tm.encode(mel, mask)
            logits, cache = tm.prefill(tokens, tmask, enc, emask,
                                       tm.make_cache(1, max_len=32))
            ref = tm.apply(mel, mask, tokens, tmask)
            np.testing.assert_allclose(logits[0].numpy(), ref[0, 2].numpy(),
                                       atol=2e-4, rtol=1e-4)
            nxt = int(torch.argmax(logits[0]))
            step, cache = tm.decode_step(
                torch.tensor([[nxt]], dtype=torch.int32), enc, emask, cache,
                torch.ones(1, dtype=torch.bool))
            tokens[0, 3] = nxt
            tmask[0, 3] = 1
            ref2 = tm.apply(mel, mask, tokens, tmask)
        np.testing.assert_allclose(step[0].numpy(), ref2[0, 3].numpy(),
                                   atol=2e-4, rtol=1e-4)

    def test_step_at_capacity_writes_nothing(self, pair):
        """A row at capacity: its k/v write is dropped (no out-of-range
        index), its length stops; the other row advances."""
        _, _, tm = pair
        rng = np.random.default_rng(6)
        mel, mask = _t(*t_asr.collate_audio([_mel(rng, 80)] * 2, 2))
        with torch.inference_mode():
            enc, emask = tm.encode(mel, mask)
            cache = tm.make_cache(2, max_len=4)
            cache.lengths.copy_(torch.tensor([4, 1], dtype=torch.int32))
            before = cache.k.clone()
            _, cache = tm.decode_step(torch.tensor([[3], [4]],
                                                   dtype=torch.int32),
                                      enc, emask, cache,
                                      torch.ones(2, dtype=torch.bool))
        assert cache.lengths.tolist() == [4, 2]
        assert torch.equal(cache.k[:, 0], before[:, 0])
        assert not torch.equal(cache.k[:, 1, 1], before[:, 1, 1])


class TestStreaming:
    def test_chunked_feed_matches_jax(self, pair):
        jm, params, tm = pair
        stream = t_asr.StreamingASR(tm, chunk_frames=100, max_new_tokens=4)
        j_stream = j_asr.StreamingASR(jm, params, chunk_frames=100,
                                      max_new_tokens=4)
        rng = np.random.default_rng(4)
        a, b = _mel(rng, 60), _mel(rng, 60)
        assert stream.feed(a) is None and j_stream.feed(a) is None
        out = stream.feed(b)
        assert out is not None and out == j_stream.feed(b)
        assert all(0 <= t < 256 for t in out)
        c = _mel(rng, 30)
        assert stream.feed(c) is None and j_stream.feed(c) is None
        more = stream.flush()
        assert more == j_stream.flush()
        total = stream.transcript
        assert total == j_stream.transcript
        assert total[0] == 254 and len(total) == 1 + len(out) + len(more)

    def test_reset_keeps_the_model_and_starts_over(self, pair):
        _, _, tm = pair
        stream = t_asr.StreamingASR(tm, chunk_frames=50, max_new_tokens=3)
        rng = np.random.default_rng(8)
        clip = _mel(rng, 70)
        first = stream.feed(clip)
        stream.reset()
        assert stream.transcript == [254] and stream.model is tm
        assert stream.feed(clip) == first


def _asr_factory():
    """One port StreamingASR per replica over the JAX params, generator
    batching one chunk (the transcript) per request — the reference's
    ``asr_factory``."""
    jm = j_reg.get_model("whisper_tiny_test", dtype=jnp.float32)
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.init(jax.random.PRNGKey(0)))
    asr = t_asr.StreamingASR(_port_model(params), chunk_frames=100,
                             max_new_tokens=4)

    def transcribe(payloads):
        results = []
        for p in payloads:
            asr.reset()
            out = asr.feed(np.asarray(p, np.float32)) or []
            if asr._buffer:
                out = out + asr.flush()
            results.append(asr.transcript)
        yield results

    return transcribe


@pytest.mark.timeout(240)
def test_transcription_roundtrip_on_the_port_controller(pair):
    """controller -> router -> replica -> StreamingASR: every transcript
    equals a direct StreamingASR run on the same audio, a ragged batch
    transcribes each clip on its own, and resubmitting reproduces it."""
    from ray_dynamic_batching_tpu_torch.serve.controller import (
        DeploymentConfig,
        ServeController,
    )
    from ray_dynamic_batching_tpu_torch.serve.handle import DeploymentHandle

    _, _, tm = pair
    rng = np.random.default_rng(1)
    clips = [_mel(rng, n) for n in (60, 120, 180, 120)]
    direct = []
    for c in clips:
        s = t_asr.StreamingASR(tm, chunk_frames=100, max_new_tokens=4)
        s.feed(c)
        if s._buffer:
            s.flush()
        direct.append(s.transcript)
    controller = ServeController(control_interval_s=0.2)
    try:
        router = controller.deploy(
            DeploymentConfig(name="whisper", num_replicas=1,
                             max_batch_size=2, batch_wait_timeout_s=0.01),
            factory=_asr_factory)
        controller.start()
        handle = DeploymentHandle(router, default_slo_ms=120_000.0)
        futs = [handle.remote(c.tolist()) for c in clips]
        outs = [f.result(timeout=120)[0] for f in futs]
        again = [handle.remote(c.tolist()).result(timeout=120)[0]
                 for c in clips[:2]]
    finally:
        controller.shutdown()
    assert outs == direct
    assert again == direct[:2]
    assert all(o[0] == 254 and len(o) > 1 for o in outs)
