"""Serving on the card at caco_base (random weights from the seed): the
engine's routes and their launch counts, each against the CPU's plain
path or the other routes, the variant paths of K6, K3′ and K8′ through
their own entry points, gradients through the inference encoder,
captioning (the caption engine, stepwise decode against teacher forcing,
the CUDA-graph step against the eager one, the graph step at bench.py's
256 streams, the continuous captioner), the
gallery at 262 144 rows against numpy, and `resample_fft` against the
host's.  Marked `cuda`; the bounds are tests/torch_card.py's."""

import dataclasses
import types

import numpy as np
import pytest
import torch

from cacophony_tpu_torch import configs
from cacophony_tpu_torch.data.tokenizer import ByteLevelBPETokenizer
from cacophony_tpu_torch.frontend import dsp, fused
from cacophony_tpu_torch.frontend.patchify import patchify_spectrogram
from cacophony_tpu_torch.models import caco
from cacophony_tpu_torch.models.audio import LN_EPS, audio_input_embedding, encoder_layer
from cacophony_tpu_torch.models.caco import caco_init, get_audio_embedding
from cacophony_tpu_torch.models.layers import layer_norm
from cacophony_tpu_torch.ops import encoder_attention as ea
from cacophony_tpu_torch.runtime import CacoEngine
from cacophony_tpu_torch.runtime.continuous import ContinuousCaptioner
from cacophony_tpu_torch.runtime.gallery import GalleryIndex
from cacophony_tpu_torch.utils import profiling
from torch_card import (COS, DECODE_REL, GALLERY_ATOL, LOG_MEL, RESAMPLE_ATOL, SCORE_TOL,  # noqa: F401
                        SEED, STEP_TOL, TOP2_GAP, WRITTEN, byte_vocab, check_close,
                        check_embeddings, clips, cosine_rows, cuda, decode_batch, drive,
                        gallery_data, launches)

pytestmark = pytest.mark.cuda

BATCH, LAYERS, H = 32, 12, 8
CHAIN = dict.fromkeys(("layer_norm", "gemm", "attention"))  # each launched at least once
N_CLIPS, N_CLIPS_30, CAPTION_CLIPS = 70, 40, 8  # 10 s: 3 buckets, the last mostly padding


@pytest.fixture(scope="module")
def base(cuda):
    """caco_base from seed 0 (moved to the card by the first engine), the
    byte-level tokenizer, 70 clips of 3-10 s and 40 of 3-30 s."""
    cfg = configs.caco_base()
    rs = np.random.RandomState(SEED)
    return types.SimpleNamespace(
        cfg=cfg, model=caco_init(cfg, torch.Generator().manual_seed(SEED)),
        tok=ByteLevelBPETokenizer(byte_vocab(), []),
        wavs=clips(rs, N_CLIPS, 3, 10), wavs30=clips(rs, N_CLIPS_30, 3, 30))


def engine(base, dtype, **kw):
    return CacoEngine(base.cfg, base.model, tokenizer=base.tok, device="cuda", batch_size=BATCH,
                      dtype=dtype, **kw)


@pytest.fixture(scope="module")
def bf16_10s(base):
    """The bf16 10-s engine and its embeddings of the 70 clips, with the
    launch counts of that call."""
    eng = engine(base, torch.bfloat16)
    emb, counts = drive(lambda: eng.embed_audio(base.wavs), {})
    return eng, emb, counts


@pytest.fixture(scope="module")
def bf16_30s(base):
    return engine(base, torch.bfloat16, buffer_seconds=30.0)


def test_bf16_10s_engine_serves_through_k1(base, bf16_10s):
    """Every layer of every bucket on K1 (K2, K3 and K8 never); embed_texts
    and score = exp(logit_scale)·A@Tᵀ."""
    eng, emb, counts = bf16_10s
    assert eng.patch.patches_seq_len == 496
    buckets = -(-N_CLIPS // BATCH)
    assert {k: counts[k] for k in ("k1_layer", "k2_block", "k3_block", "log_mel")} == {
        "k1_layer": LAYERS * buckets, "k2_block": 0, "k3_block": 0, "log_mel": 0}
    assert all(counts[k] > 0 for k in CHAIN)
    texts = ["a dog barking", "rain on a window", "a trumpet solo",
             "people talking in a crowded room", "an engine idling", "birds singing at dawn"]
    t_emb = eng.embed_texts(texts)
    check_embeddings(emb, N_CLIPS, base.cfg)
    check_embeddings(t_emb, len(texts), base.cfg)
    scores = eng.score(emb, t_emb)
    assert scores.shape == (N_CLIPS, len(texts))
    np.testing.assert_allclose(scores, np.exp(base.cfg.logit_scale_init) * emb @ t_emb.T,
                               rtol=SCORE_TOL[0], atol=SCORE_TOL[1])


def test_fp32_10s_engine_runs_k2_and_agrees(base, bf16_10s):
    """K2 on every layer, K1 never; fp32 on the card against the CPU's
    plain path (2 clips), bf16 against fp32 on the card."""
    eng = engine(base, torch.float32)
    a32, _ = drive(lambda: eng.embed_audio(base.wavs),
                   {"k2_block": LAYERS * 3, "k1_layer": 0, "k3_block": 0, **CHAIN})
    check_embeddings(a32, N_CLIPS, base.cfg)
    cpu = CacoEngine(base.cfg, caco_init(base.cfg, torch.Generator().manual_seed(SEED)),
                     tokenizer=base.tok, device="cpu", batch_size=2, dtype=torch.float32)
    assert cosine_rows(a32[:2], cpu.embed_audio(base.wavs[:2])) >= COS["fp32"]
    assert cosine_rows(bf16_10s[1], a32) >= COS["bf16"]


def test_fused_frontend_engine_runs_k8_once_a_bucket(base, bf16_10s):
    eng = engine(base, torch.bfloat16, fused_frontend=True)
    emb, _ = drive(lambda: eng.embed_audio(base.wavs),
                   {"log_mel": 3, "k1_layer": LAYERS * 3, **CHAIN})
    check_embeddings(emb, N_CLIPS, base.cfg)
    assert cosine_rows(emb, bf16_10s[1]) >= COS["fused_frontend"]


def test_30s_engine_runs_k3_and_agrees_with_fp32(base, bf16_30s):
    """bf16 at 1536 patches: K3 on every layer of both buckets, and on one
    bucket of 2 + 2 + 3 windows for `embed_audio_long`; fp32 at 1496
    patches takes the einsum route (no kernel); bf16 against fp32."""
    assert bf16_30s.patch.patches_seq_len == 1536
    a30, _ = drive(lambda: bf16_30s.embed_audio(base.wavs30),
                   {"k3_block": LAYERS * 2, "k1_layer": 0, "k2_block": 0, **CHAIN})
    check_embeddings(a30, N_CLIPS_30, base.cfg)
    rs = np.random.RandomState(SEED + 8)
    long_wavs = [(0.1 * rs.randn(s * 16000)).astype(np.float32) for s in (45, 60, 75)]
    a_long, _ = drive(lambda: bf16_30s.embed_audio_long(long_wavs),
                      {"k3_block": LAYERS, "k1_layer": 0})
    check_embeddings(a_long, len(long_wavs), base.cfg)
    eng32 = engine(base, torch.float32, buffer_seconds=30.0)
    assert eng32.patch.patches_seq_len == 1496
    a30_32, _ = drive(lambda: eng32.embed_audio(base.wavs30), dict.fromkeys(launches(), 0))
    assert cosine_rows(a30, a30_32) >= COS["bf16"]


# route → (dtype, engine options, the chain's launch-count key)
GRAPH_ROUTES = {"k1": (torch.bfloat16, {}, "k1_layer"),
                "k2": (torch.float32, {}, "k2_block"),
                "k8": (torch.bfloat16, {"fused_frontend": True}, "log_mel"),
                "k3": (torch.bfloat16, {"buffer_seconds": 30.0}, "k3_block")}


@pytest.mark.parametrize("route", list(GRAPH_ROUTES))
def test_audio_bucket_replays_its_graph_bit_for_bit(base, route):
    """`embed_audio` on a card replays one CUDA graph per bucket shape: on
    each route (bf16 10 s K1, fp32 10 s K2, fused frontend K8, bf16 30 s
    K3), two calls whose tail buckets are mostly padding equal, bit for bit
    and launch for launch, the eager `get_audio_embedding` of the same
    `audio_patch_batch` buckets; one capture, one replay a bucket; after
    block 1's weights are copied into block 0 in place, the next call
    follows the eager result without a new capture."""
    dtype, kw, chain = GRAPH_ROUTES[route]
    wavs = base.wavs30 if route == "k3" else base.wavs
    eng = engine(base, dtype, **kw)
    calls = [wavs, wavs[:BATCH + 3]]  # tail buckets of 6 (70 clips) or 8 (40), then 3

    @torch.inference_mode()
    def eager(ws):
        out = []
        for i in range(0, len(ws), BATCH):
            batch, n = eng.audio_patch_batch(ws[i:i + BATCH])
            out.append(get_audio_embedding(eng.params, eng.cfg, **batch)[0][:n].cpu().numpy())
        return np.concatenate(out)

    blocks = eng.params.audio.blocks
    saved = [p.detach().clone() for p in blocks[0].parameters()]
    firsts = []
    try:
        for new_weights in (False, True):
            if new_weights:
                with torch.no_grad():
                    for p, q in zip(blocks[0].parameters(), blocks[1].parameters()):
                        p.copy_(q)
            for j, ws in enumerate(calls):
                with profiling.recording() as rec:
                    got, graphed = drive(lambda: eng.embed_audio(ws), {})
                want, eager_counts = drive(lambda: eager(ws), {})
                assert np.array_equal(got, want), (route, new_weights, j)
                assert graphed == eager_counts and graphed[chain] > 0
                first = (j, new_weights) == (0, False)
                assert rec.counters.get("engine.audio_graph_captures", 0) == int(first)
                assert rec.counters["engine.audio_graph_replays"] == rec.counters["engine.buckets"]
                assert rec.counters["engine.buckets"] == -(-len(ws) // BATCH)
                if j == 0:
                    firsts.append(got)
    finally:
        with torch.no_grad():
            for p, s in zip(blocks[0].parameters(), saved):
                p.copy_(s)
    assert not np.array_equal(*firsts)  # the replay read the new weights
    assert list(eng._audio_graphs) == [(BATCH, eng.buffer_samples)]


def embed_by_layers(model, cfg, batch, layer):
    """get_audio_embedding with every encoder layer run by layer(blk, x, mask)."""
    mask = batch["audio_mask"]
    x = audio_input_embedding(model.audio, cfg.audio, batch["audio_patches"],
                              batch["audio_time_inds"], batch["audio_freq_inds"], cfg.dtype)
    for blk in model.audio.blocks:
        x = layer(blk, x, mask)
    hidden = layer_norm(model.audio.ln_f, x, LN_EPS)
    return caco._normalize(caco.audio_pooler_apply(model.audio_pool, cfg, hidden, mask))


@torch.inference_mode()
def test_route_k6_encoder_agrees_with_k1(base, bf16_10s):
    """The 12-layer 10-s encoder (B=32, S=496) with every layer on route
    "k6": K6 12 times and K1 never; against the K1 route."""
    cfg = dataclasses.replace(base.cfg, dtype=torch.bfloat16)
    assert ea.layer_route(496, 768, 3072, torch.bfloat16) == ("k1", 496)
    assert ea.fused_ln_attention_applies(496, 768, torch.bfloat16)
    batch = bf16_10s[0].audio_patch_batch(base.wavs[:BATCH])[0]
    ref = get_audio_embedding(base.model, cfg, **batch)[0].float().cpu().numpy()
    emb, _ = drive(lambda: embed_by_layers(
        base.model, cfg, batch, lambda b, x, m: encoder_layer(b, x, m, H, "k6", torch.bfloat16)),
        {"k6_attn": LAYERS, "k1_layer": 0, "k2_block": 0, "attention": LAYERS})
    emb = emb.float().cpu().numpy()
    check_embeddings(emb, BATCH, cfg)
    assert cosine_rows(emb, ref) >= COS["bf16"]


@torch.inference_mode()
def test_k3_prime_encoder_agrees_with_k3(base, bf16_30s):
    """The 12-layer 30-s encoder (B=8, 1536 patches) through
    `try_fused_layer(allow_blocked=True)`: K3′ 12 times, K3 never; against
    the K3 route."""
    cfg = dataclasses.replace(base.cfg, dtype=torch.bfloat16)
    batch = {k: v[:8] for k, v in bf16_30s.audio_patch_batch(base.wavs30[:8])[0].items()}
    assert batch["audio_patches"].shape[1] == 1536
    ref = get_audio_embedding(base.model, cfg, **batch)[0].float().cpu().numpy()

    def k3_prime(b, x, m):
        y = ea.try_fused_layer(b, x, m, H, LN_EPS, torch.bfloat16, allow_blocked=True)
        assert y is not None
        return y

    emb, _ = drive(lambda: embed_by_layers(base.model, cfg, batch, k3_prime),
                   {"k3_layer": LAYERS, "k3_block": 0, "k1_layer": 0})
    emb = emb.float().cpu().numpy()
    check_embeddings(emb, 8, cfg)
    assert cosine_rows(emb, ref) >= COS["bf16"]


def device_buffers(wavs, seconds: int):
    bufs = np.zeros((len(wavs), seconds * 16000), np.float32)
    for i, w in enumerate(wavs):
        bufs[i, :len(w)] = w[:bufs.shape[1]]
    lens = np.asarray([min(len(w), bufs.shape[1]) for w in wavs], np.int32)
    return torch.from_numpy(bufs).cuda(), torch.from_numpy(lens).cuda()


@torch.inference_mode()
@pytest.mark.parametrize("seconds", [10, 30])
def test_fast_dft_patches(base, bf16_10s, bf16_30s, seconds):
    """`fused_batch_wav_to_patches(fast_dft=True)`: K8′ once on 10-s
    buffers, its patches against the plain K8′'s; on 30-s buffers K8 once
    and the exact path's patches (JAX's exact fallback)."""
    eng, wavs = (bf16_10s[0], base.wavs[:BATCH]) if seconds == 10 else (bf16_30s, base.wavs30[:8])
    front = configs.FrontendConfig()
    bufs, lens = device_buffers(wavs, seconds)
    fast_k8p = int(seconds == 10)
    fast, _ = drive(lambda: fused.fused_batch_wav_to_patches(bufs, lens, front, eng.patch,
                                                             fast_dft=True),
                    {"log_mel_fast": fast_k8p, "log_mel": 1 - fast_k8p})
    exact = fused.fused_batch_wav_to_patches(bufs, lens, front, eng.patch)
    for k in ("audio_mask", "audio_time_inds", "audio_freq_inds"):
        assert torch.equal(fast[k], exact[k]), k
    if seconds == 30:
        assert torch.equal(fast["audio_patches"], exact["audio_patches"])
        return
    frames = seconds * 100
    plain = fused.fused_log_mel_plain(fused.buffer_to_rows(bufs, frames, front), front, frames,
                                      fast_dft=True)
    ref = patchify_spectrogram(plain, -(-lens // front.hop_length), eng.patch)["audio_patches"]
    check_close(fast["audio_patches"], ref, LOG_MEL)


def test_gradients_through_the_inference_encoder(base):
    """loss = Σ embedding · a fixed vector.  bf16 at B=8: K1 12 times in the
    forward, every block parameter's gradient present and finite.  fp32 at
    B=2 (K2): the audio tower's and pooler's gradients against the same
    computation on the CPU."""
    cfg, model = base.cfg, base.model
    vec = torch.randn(cfg.projection_size, generator=torch.Generator().manual_seed(SEED + 7))

    def patch_batch(dt, n):
        eng = CacoEngine(cfg, model, device="cuda", batch_size=n, dtype=dt)
        return {k: v.clone() for k, v in eng.audio_patch_batch(base.wavs[:n])[0].items()}

    def loss_backward(net, c, batch):
        emb, _ = get_audio_embedding(net, c, **batch)
        (emb @ vec.to(emb.device)).sum().backward()

    try:
        batch = patch_batch(torch.bfloat16, 8)
        model.zero_grad(set_to_none=True)
        drive(lambda: loss_backward(model, dataclasses.replace(cfg, dtype=torch.bfloat16), batch),
              {"k1_layer": LAYERS, "k2_block": 0, "k6_attn": 0, "k7": 0})
        bad = [k for k, p in model.audio.blocks.named_parameters()
               if p.grad is None or not torch.isfinite(p.grad).all()]
        assert not bad, bad[:4]
        cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
        batch = patch_batch(torch.float32, 2)
        model.zero_grad(set_to_none=True)
        drive(lambda: loss_backward(model, cfg32, batch), {"k2_block": LAYERS, "k1_layer": 0})
        cpu_model = caco_init(cfg, torch.Generator().manual_seed(SEED))
        loss_backward(cpu_model, cfg32, {k: v.cpu() for k, v in batch.items()})
        grads = [torch.cat([p.grad.flatten().double().cpu() for p in
                            list(net.audio.parameters()) + list(net.audio_pool.parameters())])
                 for net in (model, cpu_model)]
        assert float((grads[0] - grads[1]).norm() / grads[1].norm()) <= STEP_TOL["grads"]
    finally:
        model.zero_grad(set_to_none=True)


# ---- captioning ---------------------------------------------------------

def decoder_kw(tok, **kw):
    return dict(bos_id=tok.bos_token_id, eos_id=tok.eos_token_id, pad_id=tok.pad_token_id, **kw)


def stepwise(base, cfg, batch, max_length, temperature):
    """A BatchDecoder run one step at a time → (ids, per-step logits
    (B, n, V), per-step generating flags (B, n))."""
    dec = caco.BatchDecoder(base.model, cfg, batch, max_length=max_length,
                            **decoder_kw(base.tok, temperature=temperature,
                                         generator=torch.Generator(device="cuda").manual_seed(0)))
    logits, flags = [], []
    while dec.steps_left:
        flags.append(dec.state.is_generating.clone())
        dec.steps(1)
        logits.append(dec.logits.clone())
    return dec.state.input_ids.clone(), torch.stack(logits, 1), torch.stack(flags, 1)


@pytest.fixture(scope="module")
def caption_batches(base):
    """The 8 caption clips' patch batches in bf16 and fp32."""
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        eng = CacoEngine(base.cfg, base.model, device="cuda", batch_size=CAPTION_CLIPS, dtype=dt)
        out[dt] = eng.audio_patch_batch(base.wavs[:CAPTION_CLIPS])[0]
    return out


@torch.inference_mode()
@pytest.mark.parametrize("dtype,fused_frontend,expect", [
    (torch.bfloat16, False, {"k1_layer": LAYERS, "k2_block": 0, "log_mel": 0}),
    (torch.float32, False, {"k2_block": LAYERS, "k1_layer": 0}),
    (torch.bfloat16, True, {"log_mel": 1, "k1_layer": LAYERS})])
def test_caption_engine(base, dtype, fused_frontend, expect):
    """`CacoEngine.caption` with the reference's defaults (max 100, T 0.1,
    seed 42) on 8 clips: the audio pass's launches, a string a clip."""
    eng = CacoEngine(base.cfg, base.model, tokenizer=base.tok, device="cuda",
                     batch_size=CAPTION_CLIPS, dtype=dtype, fused_frontend=fused_frontend)
    caps, _ = drive(lambda: eng.caption(base.wavs[:CAPTION_CLIPS]), expect)
    assert len(caps) == CAPTION_CLIPS and all(isinstance(c, str) for c in caps)


@torch.inference_mode()
def test_fp32_decode_logits_match_teacher_forcing(base, caption_batches):
    """fp32 stepwise decode logits against the teacher-forced
    `caption_logits` on the produced tokens: max |Δ| / max |ref| over the
    live stream-steps within DECODE_REL."""
    cfg = dataclasses.replace(base.cfg, dtype=torch.float32)
    batch = caption_batches[torch.float32]
    ids, logits, flags = stepwise(base, cfg, batch, 24, 1.0)
    _, hidden = get_audio_embedding(base.model, cfg, batch["audio_patches"],
                                    batch["audio_time_inds"], batch["audio_freq_inds"],
                                    batch["audio_mask"], normalize=False)
    full = caco.caption_logits(base.model, cfg, ids[:, :-1], torch.ones_like(ids[:, :-1]), hidden,
                               batch["audio_mask"])
    live = flags.bool()
    rel = float((logits - full).abs().amax(-1)[live].max() / full.abs().amax(-1)[live].max())
    assert rel <= DECODE_REL, rel


@torch.inference_mode()
def test_graph_decode_step_equals_eager_and_bf16_agrees_with_fp32(base, caption_batches):
    """bf16 top_k=1: the CUDA-graph step gives the eager step's tokens;
    bf16 first-step logits against fp32's (cosine per stream)."""
    cfg16 = dataclasses.replace(base.cfg, dtype=torch.bfloat16)
    ids = [caco.decode(base.model, cfg16, caption_batches[torch.bfloat16], max_length=32,
                       **decoder_kw(base.tok, temperature=1.0, top_k=1, cuda_graph=graph,
                                    generator=torch.Generator(device="cuda").manual_seed(0)))
           for graph in (True, False)]
    assert torch.equal(ids[0], ids[1])
    cfg32 = dataclasses.replace(base.cfg, dtype=torch.float32)
    first = [stepwise(base, c, caption_batches[c.dtype], 2, 1.0)[1][:, 0].cpu().numpy()
             for c in (cfg16, cfg32)]
    assert cosine_rows(first[0], first[1]) >= COS["bf16"]


@torch.inference_mode()
def test_graph_decode_at_the_rate_shape_writes_every_stream(base, caption_batches):
    """bench.py's decode shape, bf16, 256 streams × 64 at 500 patches, T
    1.0, the CUDA-graph step: K1 on every layer of the one audio pass and
    no K2, and the ids written (WRITTEN)."""
    cfg16 = dataclasses.replace(base.cfg, dtype=torch.bfloat16)
    batch = decode_batch(256, SEED)
    ids, _ = drive(lambda: caco.decode(base.model, cfg16, batch, max_length=64,
                                       **decoder_kw(base.tok, temperature=1.0, cuda_graph=True,
                                                    generator=torch.Generator(device="cuda")
                                                    .manual_seed(0))),
                   {"k1_layer": LAYERS, "k2_block": 0})
    assert ids.shape == (256, 64)
    written = int(ids[:, 1:].ne(0).sum())
    assert written >= WRITTEN * 256 * 63, written


@torch.inference_mode()
@pytest.mark.parametrize("graph", [True, False])
def test_decode_steps_make_no_host_sync(base, caption_batches, graph):
    """One window of decode steps under set_sync_debug_mode("error")."""
    cfg16 = dataclasses.replace(base.cfg, dtype=torch.bfloat16)
    dec = caco.BatchDecoder(base.model, cfg16, caption_batches[torch.bfloat16], max_length=64,
                            **decoder_kw(base.tok, temperature=1.0, cuda_graph=graph,
                                         generator=torch.Generator(device="cuda")))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        dec.steps(caco.DECODE_WINDOW)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def ids_tokenizer(tok):
    """Stands in for the tokenizer: a "caption" is its ids, space-joined."""
    return types.SimpleNamespace(bos_token_id=tok.bos_token_id, eos_token_id=tok.eos_token_id,
                                 pad_token_id=tok.pad_token_id,
                                 batch_decode=lambda ids, **kw: [" ".join(map(str, r)) for r in ids])


@torch.inference_mode()
def test_continuous_captioner_prefills_through_k1_and_matches_batch_decode(base, caption_batches):
    """bf16, 48 requests on 16 slots (max_length 64, T 1.0): the prefill
    runs whole K1 passes and every request is written to its end (WRITTEN).
    Near-greedy fp32 (T 1e-6), 8 requests on 3 slots against batch decode:
    equal, or a top-two gap below TOP2_GAP where they first differ."""
    cfg16 = dataclasses.replace(base.cfg, dtype=torch.bfloat16)
    batch = caption_batches[torch.bfloat16]
    reqs = [{k: v[i % CAPTION_CLIPS:i % CAPTION_CLIPS + 1] for k, v in batch.items()}
            for i in range(48)]
    server = ContinuousCaptioner(cfg16, base.model, ids_tokenizer(base.tok), num_slots=16,
                                 max_length=64, temperature=1.0, seed=1, drain_every=32,
                                 device="cuda")
    caps, got = drive(lambda: server.run(reqs), {"k1_layer": None})
    assert got["k1_layer"] % LAYERS == 0
    assert len(caps) == len(reqs)
    written = sum(sum(int(t) != 0 for t in c.split()[1:]) for c in caps)
    assert written >= WRITTEN * len(reqs) * 63, written

    cfg32 = dataclasses.replace(base.cfg, dtype=torch.float32)
    batch = caption_batches[torch.float32]
    server = ContinuousCaptioner(cfg32, base.model, ids_tokenizer(base.tok), num_slots=3,
                                 max_length=32, temperature=1e-6, seed=0, drain_every=8,
                                 device="cuda")
    cont = server.run([{k: v[i:i + 1] for k, v in batch.items()} for i in range(CAPTION_CLIPS)])
    ids, logits, _ = stepwise(base, cfg32, batch, 32, 1e-6)
    eos = base.tok.eos_token_id
    for i, cap in enumerate(cont):
        row, ref = [int(t) for t in cap.split()], ids[i].tolist()
        end = ref.index(eos, 1) + 1 if eos in ref[1:] else len(ref)
        diff = [t for t in range(1, end) if row[t] != ref[t]]
        if diff:
            top2 = torch.topk(logits[i, diff[0] - 1], 2).values
            assert float(top2[0] - top2[1]) < TOP2_GAP, (i, diff[0])


# ---- the gallery and the resampler ------------------------------------------

def test_gallery_at_262144_rows_matches_numpy(cuda, tmp_path):
    """262 144 × 768 fp32 rows added in four parts (capacity grows past its
    131 072-row slab), 1 % deleted (twice: idempotent), 1024 queries,
    top-10: indices equal to numpy's, scores within GALLERY_ATOL; a save /
    load round trip searches alike."""
    rows_n, dim = 262_144, 768
    rows, queries, dead = gallery_data(rows_n, dim, 1024)
    g = GalleryIndex(dim, logit_scale=1.7, slab=131_072, device="cuda")
    for i in range(0, rows_n, rows_n // 4):
        g.add(rows[i:i + rows_n // 4])
    assert g.capacity == rows_n and g.size == rows_n
    g.delete(dead)
    g.delete(dead[:10])
    assert g.num_deleted == len(dead)
    scores, idx, _ = g.search(queries, k=10)
    ref = np.float32(np.exp(np.float32(1.7))) * queries @ rows.T
    ref[:, dead] = -np.inf
    top = np.argpartition(-ref, 10, axis=1)[:, :10]
    ref_idx = np.take_along_axis(top, np.argsort(-np.take_along_axis(ref, top, 1), axis=1,
                                                 kind="stable"), 1)
    np.testing.assert_array_equal(idx, ref_idx)
    np.testing.assert_allclose(scores, np.take_along_axis(ref, ref_idx, 1), rtol=0, atol=GALLERY_ATOL)
    g.save(str(tmp_path / "gallery.npz"))
    loaded = GalleryIndex.load(str(tmp_path / "gallery.npz"), device="cuda")
    s2, i2, _ = loaded.search(queries, k=10)
    assert np.array_equal(i2, idx) and np.array_equal(s2, scores)
    assert loaded.num_deleted == g.num_deleted


@pytest.mark.parametrize("rate,seconds,n", [(44_100, 5, 32), (48_000, 10, 16)])
def test_resample_fft_on_the_card_matches_the_host(cuda, rate, seconds, n):
    """`resample_fft` (torch.fft on the card) against `resample_fft_host`
    (numpy) to 16 kHz, within RESAMPLE_ATOL."""
    x = np.random.RandomState(SEED + 18).randn(n, rate * seconds).astype(np.float32)
    got = dsp.resample_fft(torch.from_numpy(x).to(cuda), 16_000 * seconds).cpu().numpy()
    ref = np.stack([dsp.resample_fft_host(c, 16_000 * seconds) for c in x])
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=RESAMPLE_ATOL)
