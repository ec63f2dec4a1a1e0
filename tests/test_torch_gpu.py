"""Kernels K1-K7 on the card against their plain PyTorch versions (K1 and
K6 also at ragged lengths, pad keys of 1e4, batch 4, and for determinism), the
serving slice through K1 and K2 (and in 4-bit cross-KV), from_file + full
over block-quantized files through K1, K3 and K2, K4 or K5 in every cross
mode, and the encoder's attention variants through K1 and K6.  Every test
here needs CUDA and skips without it.  The card has no JAX and tests/conftest.py imports it, so
run this file there without the conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from whisper_tpu_torch import (BatchTranscriber, WhisperContext,  # noqa: E402
                               full_default_params)
from whisper_tpu_torch.audio.filters import mel_filterbank  # noqa: E402
from whisper_tpu_torch.audio.mel import full_f32_matmuls  # noqa: E402
from whisper_tpu_torch.models import whisper as wm  # noqa: E402
from whisper_tpu_torch.ops import cross_attention as xa  # noqa: E402
from whisper_tpu_torch.ops import encoder_attention as ea  # noqa: E402
from whisper_tpu_torch.ops import mel_pallas as mp  # noqa: E402
from whisper_tpu_torch.ops import quantized as qm  # noqa: E402
from whisper_tpu_torch.weights import ggml_writer  # noqa: E402
from whisper_tpu_torch.weights.vocab import synthetic_vocab  # noqa: E402

pytestmark = pytest.mark.gpu

# bf16 operands on both sides, rounded at different points: the bound the
# Pallas tests use
TOL = 2e-2
# K3 and its plain version make the same bf16 roundings; only the order of
# the f32 sums differs (chip_smoke.KERNEL_TOL gives the readings)
TOL_K3 = 1e-5
# K2/K4/K5 and theirs likewise, but a softmax weight within an f32
# rounding of a bf16 tie may round the other way
TOL_XATTN = 5e-4
# K7 and its plain version: f32 throughout, summation order only
TOL_K7 = 1e-5


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    full_f32_matmuls()     # the plain versions' f32 matmuls, not TF32
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def _rel_err(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("shape", [(2, 200, 4, 64), (1, 1500, 20, 64),
                                   (1, 17, 1, 64)])
def test_k1_matches_plain_on_card(gen, shape):
    """T of 200 and 17 leave a ragged last tile; 1500 is the encoder's."""
    q, k, v = ((torch.randn(shape, generator=gen, device="cuda") * 0.3)
               .to(torch.bfloat16) for _ in range(3))
    n = ea.self_attention.launches
    got = ea.self_attention(q, k, v)
    torch.cuda.synchronize()
    assert ea.self_attention.launches == n + 1
    B, T, H, Dh = shape
    assert got.shape == (B, T, H * Dh) and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    assert _rel_err(got, ea.self_attention_ref(q, k, v)) <= TOL


@pytest.mark.parametrize("shape", [(2, 4, 64, 256), (4, 20, 64, 1500),
                                   (1, 2, 64, 37)])
def test_k2_matches_plain_on_card(gen, shape):
    """Identical int8 codes into both; Ta=37 is not a multiple of a warp."""
    B, H, Dh, Ta = shape
    q = (torch.randn(B, H, 1, Dh, generator=gen, device="cuda") * 0.3
         ).to(torch.bfloat16)
    kq, ks = xa.quantize_kv_bhdt(
        torch.randn(shape, generator=gen, device="cuda") * 0.3)
    vq, vs = xa.quantize_kv_bhdt(
        torch.randn(shape, generator=gen, device="cuda") * 0.3)
    n = xa.cross_attention_decode_q8dt.launches
    got = xa.cross_attention_decode_q8dt(q, kq, ks, vq, vs)
    torch.cuda.synchronize()
    assert xa.cross_attention_decode_q8dt.launches == n + 1
    assert got.shape == (B, H, 1, Dh) and got.dtype == torch.float32
    ref = xa.cross_attention_decode_q8dt_ref(q, kq, ks, vq, vs)
    assert _rel_err(got, ref) <= TOL_XATTN


@pytest.mark.parametrize("shape", [(1, 2, 64, 37, 3), (2, 4, 64, 256, 2),
                                   (4, 20, 64, 1500, 5), (1, 20, 64, 1500, 5),
                                   (3, 4, 128, 200, 8), (1, 1, 64, 8000, 8)])
def test_k2_groups_match_plain_on_card(gen, shape):
    """K2 with G queries a (b, h) (B, H, Dh, Ta, G): batched beam search's
    form, a stream's beams against its one cross-KV row.  Within its bound
    of the plain version; two launches give the same bits; each query's
    row is the bits of that query alone (G = 1) on the same cluster plan,
    since a CTA's sums run in the same order for every query."""
    B, H, Dh, Ta, G = shape
    q = (torch.randn(B, H, G, Dh, generator=gen, device="cuda") * 0.3
         ).to(torch.bfloat16)
    (kq, ks), (vq, vs) = (xa.quantize_kv_bhdt(
        torch.randn(B, H, Dh, Ta, generator=gen, device="cuda") * 0.3)
        for _ in range(2))
    n = xa.cross_attention_decode_q8dt.launches
    got = xa.cross_attention_decode_q8dt(q, kq, ks, vq, vs)
    torch.cuda.synchronize()
    assert xa.cross_attention_decode_q8dt.launches == n + 1
    assert got.shape == (B, H, G, Dh) and got.dtype == torch.float32
    ref = xa.cross_attention_decode_q8dt_ref(q, kq, ks, vq, vs)
    assert _rel_err(got, ref) <= TOL_XATTN
    assert torch.equal(got, xa.cross_attention_decode_q8dt(q, kq, ks, vq, vs))
    from whisper_tpu_torch.ops._build import library
    cluster = xa._q8dt_cluster(B * H, Ta, G, Dh)
    for g in (0, G - 1):
        q1 = q[:, :, g:g + 1].contiguous()
        alone = torch.empty(B, H, 1, Dh, device="cuda")
        library().call("wtt_cross_attention_q8", q1.data_ptr(),
                       kq.data_ptr(), ks.data_ptr(), vq.data_ptr(),
                       vs.data_ptr(), alone.data_ptr(), B, H, 1, Dh, Ta,
                       cluster, int(xa._q8dt_words(Ta, kq.data_ptr(),
                                                   vq.data_ptr())),
                       torch.cuda.current_stream().cuda_stream)
        assert torch.equal(alone[:, :, 0], got[:, :, g])


def test_draws_on_card_equal_cpu(gen):
    """decode/rng.py on the card: threefry bits, split keys and uniforms
    equal the CPU's bit for bit; Gumbel noise within an ulp or two (the
    card's logf is not the CPU's); categorical draws equal wherever the
    winner leads by more than 1e-5, asserted, for the three forms the
    decode loops use."""
    from whisper_tpu_torch.decode import rng
    keys = np.array([[4500, 515], [2**31 + 7, 2**32 - 1], [0, 0]], np.uint32)
    for key in (keys[0], keys):
        for fn in (lambda k, d: rng.random_bits(rng.as_key(k, d), (7, 333)),
                   lambda k, d: rng.split(rng.as_key(k, d), 3),
                   lambda k, d: rng.uniform(rng.as_key(k, d), (5, 1000))):
            assert torch.equal(fn(key, "cuda").cpu(), fn(key, "cpu"))
        g_card = rng.gumbel(rng.as_key(key, "cuda"), (64, 1000)).cpu()
        g_cpu = rng.gumbel(rng.as_key(key, "cpu"), (64, 1000))
        torch.testing.assert_close(g_card, g_cpu, rtol=1e-6, atol=1e-6)
    logits = torch.randn(3, 5, 51866, generator=gen, device="cuda") * 2.0
    logits[..., ::3] = float("-inf")
    for key, lg, shape in ((keys[0], logits[0], None),
                           (keys, logits[:, 0], None),
                           (keys[1], logits[0], (5, 5)),
                           (keys, logits, (5, 5))):
        on_card = rng.categorical(key, lg, shape)
        on_cpu = rng.categorical(key, lg.cpu(), shape)
        assert rng.categorical_margin(key, lg.cpu(), shape) > 1e-5
        assert torch.equal(on_card.cpu(), on_cpu)


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    """On the card nothing is cast quietly or sent to the plain version."""
    x = torch.randn(1, 64, 2, 64, generator=gen, device="cuda")
    with pytest.raises(TypeError):
        ea.self_attention(x, x, x, compute_dtype=torch.float32)
    with pytest.raises(ValueError):
        ea.self_attention(*(torch.zeros(1, 64, 2, 32, device="cuda",
                                        dtype=torch.bfloat16),) * 3)
    q = torch.zeros(1, 2, 1, 64, device="cuda", dtype=torch.bfloat16)
    codes = torch.zeros(1, 2, 64, 8, dtype=torch.int8, device="cuda")
    scales = torch.ones(1, 2, 8, device="cuda")
    with pytest.raises(ValueError):
        xa.cross_attention_decode_q8dt(q.float(), codes, scales, codes,
                                       scales)
    with pytest.raises(ValueError):
        xa.cross_attention_decode_q8dt(q, codes.transpose(-1, -2).contiguous()
                                       .transpose(-1, -2), scales, codes,
                                       scales)
    big = torch.zeros(1, 2, 64, 16385, dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError):          # Ta past 16384
        xa.cross_attention_decode_q8dt(q, big, big[:, :, 0].float(), big,
                                       big[:, :, 0].float())
    with pytest.raises(ValueError):          # 9 queries a (b, h)
        xa.cross_attention_decode_q8dt(q.expand(1, 2, 9, 64).contiguous(),
                                       codes, scales, codes, scales)
    # K2's plan arguments, straight to its entry point: clusters of 0, 17,
    # and 2 at Ta = 8 (more than one CTA per 64 keys); the word path on
    # codes one byte past a word boundary; 0 and 9 queries
    from whisper_tpu_torch.ops._build import library
    odd = torch.zeros(codes.numel() + 1, dtype=torch.int8,
                      device="cuda")[1:].view(codes.shape)
    out = torch.empty(1, 2, 9, 64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for k_codes, n_q, cluster, words in ((codes, 1, 0, 0), (codes, 1, 17, 0),
                                         (codes, 1, 2, 0), (odd, 1, 1, 1),
                                         (codes, 0, 1, 0), (codes, 9, 1, 0)):
        with pytest.raises(RuntimeError):
            library().call("wtt_cross_attention_q8", q.data_ptr(),
                           k_codes.data_ptr(), scales.data_ptr(),
                           k_codes.data_ptr(), scales.data_ptr(),
                           out.data_ptr(), 1, 2, n_q, 64, 8, cluster, words,
                           stream)


def test_batch_transcriber_on_card_runs_both_kernels(gen):
    """The slice at small widths (head dim 64, as K1 requires) in bf16."""
    dims = (51864, 32, 128, 2, 2, 48, 128, 2, 2, 80)
    ctx = WhisperContext.from_random(dims=dims, seed=1, device="cuda")
    p = full_default_params()
    p.print_progress = False
    p.temperature_inc = 0.0
    p.no_timestamps = True
    p.max_tokens = 8
    bt = BatchTranscriber(ctx, batch_size=2, params=p, device_mel=True)
    rng = np.random.RandomState(0)
    streams = [(rng.randn(16000 * s) * 0.1 * 32768).clip(-32768, 32767)
               .astype(np.int16) for s in (5, 9)]
    ea.self_attention.launches = 0
    xa.cross_attention_decode_q8dt.launches = 0
    result = bt.transcribe(streams)
    torch.cuda.synchronize()
    assert ea.self_attention.launches > 0
    assert xa.cross_attention_decode_q8dt.launches > 0
    for segs in result:
        assert segs
        assert np.isfinite([t.p for s in segs for t in s.tokens]).all()


def test_batch_transcriber_beam_and_bo5_on_card(gen):
    """Beam 5 (two streams x five beams: K2 with G = 5) and best_of 5 with
    the ladder live (t > 0 rungs with draws on the card) at small widths
    in bf16."""
    dims = (51864, 32, 128, 2, 2, 48, 128, 2, 3, 80)
    ctx = WhisperContext.from_random(dims=dims, seed=1, device="cuda")
    rng = np.random.RandomState(0)
    streams = [(rng.randn(16000 * s) * 0.1 * 32768).clip(-32768, 32767)
               .astype(np.int16) for s in (5, 9)]
    for strategy in (1, 0):
        p = full_default_params(strategy)
        p.print_progress = False
        p.no_timestamps = True
        p.max_tokens = 8
        p.logprob_thold = 0.0          # every rung but the last fails
        bt = BatchTranscriber(ctx, batch_size=10, params=p, device_mel=True)
        xa.cross_attention_decode_q8dt.launches = 0
        xa.cross_attention_decode_q8dt.launches_grouped = 0
        result = bt.transcribe(streams)
        torch.cuda.synchronize()
        grouped = xa.cross_attention_decode_q8dt.launches_grouped
        assert (grouped > 0) == (strategy == 1)
        assert xa.cross_attention_decode_q8dt.launches > 0
        assert bt.n_retried_windows == 2
        for segs in result:
            assert segs
            assert np.isfinite([t.p for s in segs for t in s.tokens]).all()


def test_segment_parity_on_card(gen, tmp_path):
    """The port in bf16 on the card against whisper_tpu's segments on the
    CPU (tests/port_parity.py): greedy and beam 5, each stream's held
    golden tokens emitted; greedy teacher-forced, the golden token first
    at each decided step."""
    import hashlib
    import port_parity as pp
    golden = pp.load_golden()
    path = pp.write_model(tmp_path / "parity.bin")
    assert (hashlib.sha256(open(path, "rb").read()).hexdigest()
            == golden["model_sha256"])
    ctx = WhisperContext.from_file(path, cross_mode=pp.CROSS_MODE)
    for config in pp.CONFIGS:
        bt = BatchTranscriber(ctx, batch_size=pp.BATCH,
                              params=pp.params(full_default_params, config),
                              device_mel=True)
        pp.compare(config, bt.transcribe(pp.streams(config)), golden)
        if config == "greedy":
            pp.check_decided(
                [pp.teacher_forced_gaps(ctx, bt, pcm, ref["tokens"])
                 for pcm, ref in zip(pp.streams(config),
                                     golden[config]["streams"])], golden)


def _packed(gen, K, N, mins):
    codes = torch.randint(-16, 16, (K, N), generator=gen, device="cuda",
                          dtype=torch.int8)
    scales = (torch.rand(K // 32, N, generator=gen, device="cuda") * 2e-3
              + 1e-4)
    offs = (-16 * scales * torch.rand(K // 32, N, generator=gen,
                                      device="cuda")) if mins else None
    return codes, scales, offs


K3_SHAPES = [(1280, 1280), (1280, 5120), (5120, 1280), (768, 768),
             (768, 3072), (3072, 768), (128, 384)]


@pytest.mark.parametrize("mins", [False, True])
@pytest.mark.parametrize("M", [1, 2, 3, 4, 5, 6, 7, 8, 9, 40, 232, 2000])
@pytest.mark.parametrize("K,N", K3_SHAPES)
def test_k3_matches_plain_on_card(gen, K, N, M, mins):
    """large-v3's and small's decoder shapes (clusters of 1-16 CTAs at
    M <= 8, of 1-8 at M > 8) and a micro one; M = 1..8 each (M = 1 as in
    `full`, 4 as in serving: every M tile of the one-launch path and its
    padding), 232 as in the carried-prompt pass, 9, 40 and 2000 (a serving
    batch's prompt pass) on the wgmma path, every one of them with a
    ragged last 128-row tile.  Two launches give the same bits."""
    codes, scales, offs = _packed(gen, K, N, mins)
    x = torch.randn(M, K, generator=gen, device="cuda")
    n = qm.quantized_matmul.launches
    got = qm.quantized_matmul(x, codes, scales, offs)
    torch.cuda.synchronize()
    assert qm.quantized_matmul.launches == n + 1
    assert got.shape == (M, N) and got.dtype == torch.float32
    ref = qm.quantized_matmul_ref(x, codes, scales, offs)
    assert _rel_err(got, ref) <= TOL_K3
    assert torch.equal(got, qm.quantized_matmul(x, codes, scales, offs))


@pytest.mark.parametrize("mins", [False, True])
@pytest.mark.parametrize("M", [1, 3, 8, 232])
@pytest.mark.parametrize("K,N", [(1280, 1280), (3072, 768)])
def test_k3_rounds_x_itself(gen, K, N, M, mins):
    """K3 reads x in its own dtype and rounds it to bf16 first: an f32 x
    and the same x rounded to bf16 beforehand give the same bits."""
    codes, scales, offs = _packed(gen, K, N, mins)
    x = torch.randn(M, K, generator=gen, device="cuda")
    got = qm.quantized_matmul(x, codes, scales, offs)
    assert torch.equal(got, qm.quantized_matmul(x.to(torch.bfloat16), codes,
                                                scales, offs))


@pytest.mark.parametrize("M", [1, 4, 232])
def test_linear_packed_passes_x_uncast(gen, M):
    """`_linear` over a packed weight hands x to K3 uncast: the same bits
    as K3 on x cast to the compute dtype first, plus the bias."""
    codes, scales, offs = _packed(gen, 768, 3072, True)
    x = torch.randn(M, 1, 768, generator=gen, device="cuda")
    b = torch.randn(3072, generator=gen, device="cuda")
    w = {"q": codes, "s": scales, "m": offs}
    for cd in (torch.bfloat16, torch.float32):
        got = wm._linear(x, w, b, cd)
        y = qm.quantized_matmul(x[:, 0].to(cd), codes, scales, offs)
        assert torch.equal(got, (y + b)[:, None])


def _bhtd(gen, B, H, Ta, Dh=64):
    return [(torch.randn(B, H, n, Dh, generator=gen, device="cuda") * 0.3
             ).to(torch.bfloat16) for n in (1, Ta, Ta)]


@pytest.mark.parametrize("shape", [(2, 4, 37), (2, 4, 256), (1, 12, 1500),
                                   (1, 20, 1500), (4, 20, 1500)])
def test_k4_k5_match_plain_on_card(gen, shape):
    """Ta = 37 is not a multiple of the 32 rows a block reads per step."""
    q, k, v = _bhtd(gen, *shape)
    n4 = xa.cross_attention_decode.launches
    got = xa.cross_attention_decode(q, k, v)
    torch.cuda.synchronize()
    assert xa.cross_attention_decode.launches == n4 + 1
    assert got.shape == q.shape and got.dtype == torch.float32
    assert _rel_err(got, xa.cross_attention_decode_ref(q, k, v)) <= TOL_XATTN

    kq, ks = xa.quantize_kv(k.float())
    vq, vs = xa.quantize_kv(v.float())
    n5 = xa.cross_attention_decode_q8.launches
    got = xa.cross_attention_decode_q8(q, kq, ks, vq, vs)
    torch.cuda.synchronize()
    assert xa.cross_attention_decode_q8.launches == n5 + 1
    ref = xa.cross_attention_decode_q8_ref(q, kq, ks, vq, vs)
    assert _rel_err(got, ref) <= TOL_XATTN


@pytest.mark.parametrize("Ta", [1, 37, 64, 65, 1500, 16384])
@pytest.mark.parametrize("B,H", [(1, 12), (1, 20), (4, 20)])
def test_k4_cluster_matches_plain_on_card(gen, B, H, Ta):
    """K4's cluster split of Ta: one CTA (Ta <= 64), ranges of 32 and
    33 keys (65), ranges of up to 96 keys in one copy each (1500
    at batch 1), and 384-key (1500 at (4,20)) or 1,024-key ranges (16384)
    through the 4-stage ring of 128 keys.  Two launches give the same
    bits."""
    q, k, v = _bhtd(gen, B, H, Ta)
    n = xa.cross_attention_decode.launches
    got = xa.cross_attention_decode(q, k, v)
    torch.cuda.synchronize()
    assert xa.cross_attention_decode.launches == n + 1
    assert got.shape == q.shape and torch.isfinite(got).all()
    assert _rel_err(got, xa.cross_attention_decode_ref(q, k, v)) <= TOL_XATTN
    assert torch.equal(got, xa.cross_attention_decode(q, k, v))


XATTN_TA = [1, 37, 64, 65, 1500, 16384]
XATTN_BH = [(1, 12), (1, 20), (4, 20), (64, 20)]


def _codes(gen, *shape):
    """Random int8 codes in [-127, 127]."""
    return torch.randint(-127, 128, shape, generator=gen, device="cuda",
                         dtype=torch.int8)


def _scales(gen, *shape):
    """Per-position scales such that the logits spread over a few units."""
    return torch.rand(*shape, generator=gen, device="cuda") * 0.04 + 0.005


@pytest.mark.parametrize("Ta", XATTN_TA)
@pytest.mark.parametrize("B,H", XATTN_BH)
def test_k2_cluster_matches_plain_on_card(gen, B, H, Ta):
    """K2's cluster split of Ta on its (B, H, Dh, Ta) layout: one CTA
    (Ta <= 64, and every Ta at B*H = 1280), else up to 16 ranges of whole
    16-key chunks; the word path at Ta % 4 == 0 (64, 1500, 16384), the
    byte path at 1, 37 and 65.  Two launches give the same bits."""
    q = _bf16_randn(gen, B, H, 1, 64)
    kq, vq = _codes(gen, B, H, 64, Ta), _codes(gen, B, H, 64, Ta)
    ks, vs = _scales(gen, B, H, Ta), _scales(gen, B, H, Ta)
    assert xa._q8dt_words(Ta, kq.data_ptr(), vq.data_ptr()) == (Ta % 4 == 0)
    n = xa.cross_attention_decode_q8dt.launches
    got = xa.cross_attention_decode_q8dt(q, kq, ks, vq, vs)
    torch.cuda.synchronize()
    assert xa.cross_attention_decode_q8dt.launches == n + 1
    assert got.shape == q.shape and torch.isfinite(got).all()
    ref = xa.cross_attention_decode_q8dt_ref(q, kq, ks, vq, vs)
    assert _rel_err(got, ref) <= TOL_XATTN
    assert torch.equal(got, xa.cross_attention_decode_q8dt(q, kq, ks, vq, vs))


@pytest.mark.parametrize("B,H,Ta", [(1, 20, 1500), (4, 20, 1500),
                                    (2, 3, 64)])
def test_k2_byte_path_on_unaligned_codes(gen, B, H, Ta):
    """Codes one byte past a word boundary take K2's byte path even at
    Ta % 4 == 0, and give the word path's bits: the same sums in the same
    order, only the loads differ."""
    q = _bf16_randn(gen, B, H, 1, 64)
    kq, vq = _codes(gen, B, H, 64, Ta), _codes(gen, B, H, 64, Ta)
    ks, vs = _scales(gen, B, H, Ta), _scales(gen, B, H, Ta)
    odd = []
    for x in (kq, vq):
        y = torch.empty(x.numel() + 1, dtype=torch.int8,
                        device="cuda")[1:].view(x.shape)
        y.copy_(x)
        odd.append(y)
    assert not xa._q8dt_words(Ta, odd[0].data_ptr(), odd[1].data_ptr())
    got = xa.cross_attention_decode_q8dt(q, odd[0], ks, odd[1], vs)
    words = xa.cross_attention_decode_q8dt(q, kq, ks, vq, vs)
    torch.cuda.synchronize()
    assert torch.equal(got, words)
    ref = xa.cross_attention_decode_q8dt_ref(q, kq, ks, vq, vs)
    assert _rel_err(got, ref) <= TOL_XATTN


@pytest.mark.parametrize("Ta", XATTN_TA)
@pytest.mark.parametrize("B,H", XATTN_BH)
def test_k5_cluster_matches_plain_on_card(gen, B, H, Ta):
    """K5, the int8 instance of K4's cluster template: one CTA (Ta <= 64,
    and every Ta at B*H = 1280), ranges of up to 96 keys in one copy each
    (1500 at batch 1), 384-key ranges (1500 at (4,20)) and longer through
    the 4-stage ring of 256 keys.  Two launches give the same bits."""
    q = _bf16_randn(gen, B, H, 1, 64)
    kq, vq = _codes(gen, B, H, Ta, 64), _codes(gen, B, H, Ta, 64)
    ks, vs = _scales(gen, B, H, Ta, 1), _scales(gen, B, H, Ta, 1)
    n = xa.cross_attention_decode_q8.launches
    got = xa.cross_attention_decode_q8(q, kq, ks, vq, vs)
    torch.cuda.synchronize()
    assert xa.cross_attention_decode_q8.launches == n + 1
    assert got.shape == q.shape and torch.isfinite(got).all()
    ref = xa.cross_attention_decode_q8_ref(q, kq, ks, vq, vs)
    assert _rel_err(got, ref) <= TOL_XATTN
    assert torch.equal(got, xa.cross_attention_decode_q8(q, kq, ks, vq, vs))


@pytest.mark.parametrize("kernel", ["K2", "K5"])
@pytest.mark.parametrize("Ta", [37, 1501])
def test_q8_kernels_on_layer_slices(gen, kernel, Ta):
    """decode_step hands K2 and K5 layer l of the stacked cross-KV: at odd
    Ta and an odd number of heads, layer 1's scales start 4-byte aligned
    only (and K2's codes 1-byte aligned)."""
    L, B, H = 3, 1, 5
    q = _bf16_randn(gen, B, H, 1, 64)
    if kernel == "K2":
        kq, vq = _codes(gen, L, B, H, 64, Ta), _codes(gen, L, B, H, 64, Ta)
        ks, vs = _scales(gen, L, B, H, Ta), _scales(gen, L, B, H, Ta)
        fn, plain = (xa.cross_attention_decode_q8dt,
                     xa.cross_attention_decode_q8dt_ref)
    else:
        kq, vq = _codes(gen, L, B, H, Ta, 64), _codes(gen, L, B, H, Ta, 64)
        ks, vs = _scales(gen, L, B, H, Ta, 1), _scales(gen, L, B, H, Ta, 1)
        fn, plain = (xa.cross_attention_decode_q8,
                     xa.cross_attention_decode_q8_ref)
    assert ks[1].data_ptr() % 16 != 0
    for layer in range(L):
        args = (q, kq[layer], ks[layer], vq[layer], vs[layer])
        got = fn(*args)
        torch.cuda.synchronize()
        assert _rel_err(got, plain(*args)) <= TOL_XATTN


def test_new_wrappers_refuse_on_card(gen):
    codes, scales, offs = _packed(gen, 256, 256, True)
    x = torch.randn(2, 256, device="cuda")
    with pytest.raises(ValueError):          # f16 scales
        qm.quantized_matmul(x, codes, scales.half())
    with pytest.raises(ValueError):          # (N, K) codes
        qm.quantized_matmul(x, codes[:, :128].contiguous(), scales)
    with pytest.raises(ValueError):          # not contiguous
        qm.quantized_matmul(x, codes.t().contiguous().t(), scales, offs)
    with pytest.raises(ValueError):          # N not a multiple of 128
        qm.quantized_matmul(x, codes[:, :96].contiguous(),
                            scales[:, :96].contiguous())
    q, k, v = _bhtd(gen, 1, 2, 40)
    with pytest.raises(ValueError):          # f32 query
        xa.cross_attention_decode(q.float(), k, v)
    with pytest.raises(ValueError):          # (B, H, Dh, Ta) layout
        xa.cross_attention_decode(q, k.transpose(-1, -2), v)
    with pytest.raises(ValueError):          # head dim 32
        xa.cross_attention_decode(q[..., :32].contiguous(),
                                  k[..., :32].contiguous(),
                                  v[..., :32].contiguous())
    q, k, v = _bhtd(gen, 1, 2, 16385)
    with pytest.raises(ValueError):          # Ta past 16384
        xa.cross_attention_decode(q, k, v)
    kq, ks = xa.quantize_kv(k.float())
    with pytest.raises(ValueError):          # scales without the last axis
        xa.cross_attention_decode_q8(q, kq, ks[..., 0], kq, ks[..., 0])
    with pytest.raises(ValueError):          # Ta past 16384
        xa.cross_attention_decode_q8(q, kq, ks, kq, ks)
    # K5's plan arguments, straight to its entry point: a cluster of 17, a
    # cluster past one CTA per 64 keys, 1 and 9 stages, stages past 64 KB
    from whisper_tpu_torch.ops._build import library
    q, k, v = _bhtd(gen, 1, 2, 256)
    kq, ks = xa.quantize_kv(k.float())
    out = torch.empty(1, 2, 1, 64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for plan in ((17, 16, 2), (5, 64, 2), (1, 128, 1), (1, 16, 9),
                 (1, 512, 4)):
        with pytest.raises(RuntimeError):
            library().call("wtt_cross_attention_bhtd_q8", q.data_ptr(),
                           kq.data_ptr(), ks.data_ptr(), kq.data_ptr(),
                           ks.data_ptr(), out.data_ptr(), 1, 2, 64, 256,
                           *plan, stream)


def test_k3_prompt_entry_refuses_bad_plans(gen):
    """K3's M > 8 entry point takes clusters of 1, 2, 4 or 8 CTAs, never
    more than K's 32-row blocks: 0, 3, 16, and 8 at K = 128 are refused
    before anything launches."""
    from whisper_tpu_torch.ops._build import library
    codes, scales, _ = _packed(gen, 128, 128, False)
    x = torch.randn(40, 128, generator=gen, device="cuda")
    out = torch.empty(40, 128, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for cluster in (0, 3, 16, 8):
        with pytest.raises(RuntimeError):
            library().call("wtt_quantized_matmul", x.data_ptr(), 0,
                           codes.data_ptr(), scales.data_ptr(), 0,
                           out.data_ptr(), 40, 128, 128, cluster, stream)
    library().call("wtt_quantized_matmul", x.data_ptr(), 0, codes.data_ptr(),
                   scales.data_ptr(), 0, out.data_ptr(), 40, 128, 128, 4,
                   stream)
    torch.cuda.synchronize()
    assert _rel_err(out, qm.quantized_matmul_ref(x, codes, scales)) <= TOL_K3


@pytest.mark.parametrize("kind,cross_mode,audio_ctx", [
    ("q5_0", "pallas_q8", 0), ("q5_1", "pallas", 0),
    ("q5_0", "pallas_q8", 37)])
def test_full_from_file_on_card(gen, tmp_path, kind, cross_mode, audio_ctx):
    """whisper_full at small widths (head dim 64) in bf16 over a
    block-quantized file: K1, K3 (with mins for q5_1) and K4 or K5.
    audio_ctx=37 shrinks Ta to an odd length, so each layer's K5 scales
    start at an address that is a multiple of 4 bytes only."""
    dims = (51865, 64, 128, 2, 2, 48, 128, 2, 3, 80)
    hp = dict(zip(ggml_writer.HPARAM_KEYS, dims))
    path = str(tmp_path / f"{kind}.bin")
    ggml_writer.write_random_model(
        path, hp, mel_filterbank(80), synthetic_vocab(dims[0]).id_to_token[
            :50257], kind, seed=1)
    ctx = WhisperContext.from_file(path, device="cuda",
                                   cross_mode=cross_mode)
    p = full_default_params()
    p.print_progress = False
    p.temperature_inc = 0.0
    p.max_tokens = 16
    p.audio_ctx = audio_ctx
    pcm = (np.random.RandomState(0).randn(16000 * 5) * 0.1).astype(
        np.float32)
    kernel = (xa.cross_attention_decode_q8 if cross_mode == "pallas_q8"
              else xa.cross_attention_decode)
    for fn in (ea.self_attention, qm.quantized_matmul, kernel):
        fn.launches = 0
    assert ctx.full(p, pcm) == 0
    torch.cuda.synchronize()
    assert ea.self_attention.launches > 0
    assert qm.quantized_matmul.launches > 0
    assert kernel.launches > 0
    segs = ctx.result_all
    assert segs
    assert np.isfinite([t.p for s in segs for t in s.tokens]).all()


@pytest.mark.parametrize("strategy", [0, 1], ids=["greedy", "beam"])
def test_full_default_ladder_on_card(gen, tmp_path, strategy):
    """whisper_full with full_default_params as they come (the ladder live,
    best_of 5; beam 5 for beam search) over a q5_0 file in pallas_q8 at
    small widths in bf16: the t > 0 rungs run (logprob_thold 0 fails every
    rung but the last) with their draws on the card; K5 runs in the greedy
    rungs, while the beam reads the dense cross-KV through the einsum, as
    whisper_tpu's serial beam does."""
    dims = (51865, 64, 128, 2, 2, 48, 128, 2, 3, 80)
    hp = dict(zip(ggml_writer.HPARAM_KEYS, dims))
    path = str(tmp_path / "q5_0.bin")
    ggml_writer.write_random_model(
        path, hp, mel_filterbank(80), synthetic_vocab(dims[0]).id_to_token[
            :50257], "q5_0", seed=1)
    ctx = WhisperContext.from_file(path, device="cuda",
                                   cross_mode="pallas_q8")
    p = full_default_params(strategy)
    assert p.temperature_inc == 0.2 and p.greedy.best_of == 5
    p.print_progress = False
    p.max_tokens = 8
    p.logprob_thold = 0.0
    pcm = (np.random.RandomState(0).randn(16000 * 5) * 0.1).astype(
        np.float32)
    xa.cross_attention_decode_q8.launches = 0
    assert ctx.full(p, pcm) == 0
    torch.cuda.synchronize()
    # every window fails rungs 0.0-0.8 and emits at 1.0
    assert ctx.timings.n_fail_p >= 5 and ctx.timings.n_fail_p % 5 == 0
    assert (xa.cross_attention_decode_q8.launches > 0) == (strategy == 0)
    segs = ctx.result_all
    assert segs
    assert np.isfinite([t.p for s in segs for t in s.tokens]).all()


def _bf16_randn(gen, *shape):
    return (torch.randn(*shape, generator=gen, device="cuda") * 0.3).to(
        torch.bfloat16)


@pytest.mark.parametrize("B,Tp,H,t_valid", [(1, 1536, 20, 1500),
                                            (2, 256, 2, 200),
                                            (1, 256, 3, 17)])
def test_k6_matches_plain_on_card(gen, B, Tp, H, t_valid):
    """K6 on (B, Tp, H*64) with keys past t_valid masked; padded rows are
    computed too (t_valid = 17 leaves most of the rows padding)."""
    q, k, v = (_bf16_randn(gen, B, Tp, H * 64) for _ in range(3))
    n = ea.encoder_attention_btd.launches
    got = ea.encoder_attention_btd(q, k, v, n_head=H, t_valid=t_valid)
    torch.cuda.synchronize()
    assert ea.encoder_attention_btd.launches == n + 1
    assert got.shape == q.shape and got.dtype == torch.float32
    ref = ea.encoder_attention_btd_ref(q, k, v, H, t_valid)
    assert _rel_err(got, ref) <= TOL


@pytest.mark.parametrize("B,H,Tp,t_valid", [(1, 20, 1536, 1500),
                                            (2, 2, 256, 200),
                                            (1, 3, 72, 72)])
def test_k1_bhdt_entry_matches_plain_on_card(gen, B, H, Tp, t_valid):
    """K1's (B, H, Dh, Tp) entry, read Dh-major; Tp = 72 leaves a ragged
    last tile."""
    q, k, v = (_bf16_randn(gen, B, H, 64, Tp) for _ in range(3))
    n = ea.encoder_attention.launches
    got = ea.encoder_attention(q, k, v, t_valid=t_valid)
    torch.cuda.synchronize()
    assert ea.encoder_attention.launches == n + 1
    assert got.shape == q.shape and got.dtype == torch.float32
    assert _rel_err(got, ea.encoder_attention_ref(q, k, v, t_valid)) <= TOL


def _padded_entry(gen, entry, B, H, Tp, t_valid, pad=1e4):
    """q/k/v of K6 ("btd", (B, Tp, H*64)) or K1's Dh-major entry ("bhdt",
    (B, H, 64, Tp)) with the keys and values at or past t_valid set to
    `pad`: a kernel that masked by data, not by index, would let them in.
    -> (kernel output, plain output)."""
    if entry == "btd":
        q, k, v = (_bf16_randn(gen, B, Tp, H * 64) for _ in range(3))
        for x in (k, v):
            x[:, t_valid:] = pad
        return (ea.encoder_attention_btd(q, k, v, n_head=H, t_valid=t_valid),
                ea.encoder_attention_btd_ref(q, k, v, H, t_valid))
    q, k, v = (_bf16_randn(gen, B, H, 64, Tp) for _ in range(3))
    for x in (k, v):
        x[..., t_valid:] = pad
    return (ea.encoder_attention(q, k, v, t_valid=t_valid),
            ea.encoder_attention_ref(q, k, v, t_valid))


@pytest.mark.parametrize("t_valid", [1, 127, 128, 129, 1500])
@pytest.mark.parametrize("entry", ["btd", "bhdt"])
def test_padded_entries_mask_keys_by_index(gen, entry, t_valid):
    """K6 and K1's Dh-major entry at Tp = 1536: t_valid inside, at and just
    past a 128-key tile's edge, one key, the encoder's 1500; pad keys 1e4."""
    got, ref = _padded_entry(gen, entry, 1, 3, 1536, t_valid)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert _rel_err(got, ref) <= TOL


@pytest.mark.parametrize("T", [1, 17, 129, 1500])
def test_k1_rows_entry_ragged_T(gen, T):
    """K1's (B, T, H, Dh) entry: TMA zero-fills the rows past T of the last
    tile and the kernel masks them; only rows < T are written."""
    q, k, v = (_bf16_randn(gen, 1, T, 3, 64) for _ in range(3))
    got = ea.self_attention(q, k, v)
    torch.cuda.synchronize()
    assert got.shape == (1, T, 192) and torch.isfinite(got).all()
    assert _rel_err(got, ea.self_attention_ref(q, k, v)) <= TOL


@pytest.mark.parametrize("entry", ["rows", "btd", "bhdt"])
def test_attention_entries_at_batch_4(gen, entry):
    """B = 4 in every entry: each batch's rows come from its own tensor-map
    coordinate."""
    if entry == "rows":
        q, k, v = (_bf16_randn(gen, 4, 1500, 3, 64) for _ in range(3))
        got, ref = ea.self_attention(q, k, v), ea.self_attention_ref(q, k, v)
    else:
        got, ref = _padded_entry(gen, entry, 4, 3, 1536, 1500)
    torch.cuda.synchronize()
    assert _rel_err(got, ref) <= TOL
    # each batch on its own, too: a batch offset error would mix them
    for i in range(4):
        assert _rel_err(got[i], ref[i]) <= TOL


@pytest.mark.parametrize("entry", ["rows", "btd", "bhdt"])
def test_attention_kernel_is_deterministic(gen, entry):
    """Two launches on the same inputs give the same bits."""
    if entry == "rows":
        q, k, v = (_bf16_randn(gen, 2, 1500, 4, 64) for _ in range(3))
        outs = [ea.self_attention(q, k, v) for _ in range(2)]
    elif entry == "btd":
        q, k, v = (_bf16_randn(gen, 2, 1536, 256) for _ in range(3))
        outs = [ea.encoder_attention_btd(q, k, v, n_head=4, t_valid=1500)
                for _ in range(2)]
    else:
        q, k, v = (_bf16_randn(gen, 2, 4, 64, 1536) for _ in range(3))
        outs = [ea.encoder_attention(q, k, v, t_valid=1500) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_linear_bias_add_rounds_once_on_card(gen, out_dtype):
    """The encoder's projections: the bf16 product widened, plus the f32
    bias, rounded once to out_dtype in the add, bit for bit what a
    separate widening, add and cast give."""
    x = torch.randn(300, 256, generator=gen, device="cuda")
    w = _bf16_randn(gen, 384, 256)
    b = torch.randn(384, generator=gen, device="cuda")
    got = wm._linear(x, w, b, torch.bfloat16, out_dtype)
    y = torch.nn.functional.linear(x.to(torch.bfloat16), w)
    assert got.dtype == out_dtype
    assert torch.equal(got, (y.float() + b).to(out_dtype))


@pytest.mark.parametrize("n_frames", [None, 37, 100])
@pytest.mark.parametrize("n_mels", [80, 128])
@pytest.mark.parametrize("seconds", [5, 60])
def test_k7_matches_plain_on_card(gen, n_mels, seconds, n_frames):
    """K7 on a padded signal's row views (not copies), and log_mel_pallas
    through it.  n_frames: the first 37 or 100 frames only, not a multiple
    of the 36 frames of a CTA: the same bits as those frames of the whole
    signal, held against the plain version's rows of the whole signal
    (cuBLAS takes another algorithm at so few rows: at 5 s, 100 frames,
    128 mels its log-mel lay 2.6e-4 from a float64 reference where K7's
    lay 8.1e-5, as on the whole signal)."""
    from whisper_tpu_torch.audio.mel import pad_audio
    pcm = (np.random.RandomState(seconds).randn(16000 * seconds) * 0.1
           ).astype(np.float32)
    padded = torch.from_numpy(pad_audio(pcm)[0]).cuda()
    args = mp.mel_block_inputs(padded, mel_filterbank(n_mels))
    ref = mp._mel_blocks_ref(*args)
    if n_frames is not None:
        whole = mp._mel_blocks(*args)
        args = [a[:n_frames] for a in args[:3]] + list(args[3:])
        ref = ref[:n_frames]
    n = mp._mel_blocks.launches
    got = mp._mel_blocks(*args)
    torch.cuda.synchronize()
    assert mp._mel_blocks.launches == n + 1
    assert got.shape == (args[0].shape[0], n_mels)
    assert torch.isfinite(got).all()
    assert _rel_err(got, ref) <= TOL_K7
    if n_frames is not None:
        assert torch.equal(got, whole[:n_frames])
        return
    mel = mp.log_mel_pallas(padded, mel_filterbank(n_mels))
    assert mp._mel_blocks.launches == n + 2
    assert float(mel.max()) == pytest.approx(
        (float(got.max()) + 4.0) / 4.0, rel=1e-6)


def test_k6_k7_refuse_what_the_kernels_do_not_take(gen):
    x = _bf16_randn(gen, 1, 256, 128)
    with pytest.raises(ValueError):          # f32
        ea.encoder_attention_btd(x.float(), x.float(), x.float(), n_head=2)
    with pytest.raises(ValueError):          # head dim 32
        ea.encoder_attention_btd(x, x, x, n_head=4)
    y = _bf16_randn(gen, 1, 2, 64, 260)
    with pytest.raises(ValueError):          # Tp not a multiple of 8
        ea.encoder_attention(y, y, y)
    padded = torch.zeros(16000 * 31, device="cuda")
    args = list(mp.mel_block_inputs(padded, mel_filterbank(80)))
    with pytest.raises(ValueError):          # 64 mels
        mp._mel_blocks(*args[:-1], args[-1][:, :64].contiguous())
    with pytest.raises(ValueError):          # no frames
        mp._mel_blocks(*(a[:0] for a in args[:3]), *args[3:])


def test_encoder_variants_on_card(gen):
    """The default attn_impl on CUDA tensors is "pallas" (K1); every
    variant agrees with it in bf16, pallas_btd through K6, pallas_dt and
    pallas_pf through K1's Dh-major entry."""
    from whisper_tpu_torch.weights.convert import random_params
    dims = (51864, 200, 128, 2, 2, 48, 128, 2, 2, 80)
    cfg = wm.WhisperConfig(*dims)
    params = random_params(cfg, seed=2, device="cuda")
    mel = torch.randn(2, 400, 80, generator=gen, device="cuda")
    assert wm.default_encoder_attn_impl(mel) == "pallas"
    with torch.no_grad():
        base = wm.encode(params, mel, n_head=2)
        for impl, counter in (("pallas_dt", ea.encoder_attention),
                              ("pallas_pf", ea.encoder_attention),
                              ("pallas_btd", ea.encoder_attention_btd),
                              ("flash", ea.self_attention),
                              ("pallas_btd_interpret", None)):
            n = counter.launches if counter else 0
            got = wm.encode(params, mel, n_head=2, attn_impl=impl)
            torch.cuda.synchronize()
            if counter:
                assert counter.launches == n + cfg.n_audio_layer, impl
            assert _rel_err(got, base) <= TOL, impl
        bdt = wm.encode(params, mel, n_head=2, attn_impl="pallas_dt",
                        out_layout="bdt")
        (kq, ks), _ = wm.cross_kv_q8(params, bdt, n_head=2,
                                     enc_layout="bdt")
        (kq2, ks2), _ = wm.cross_kv_q8(params, bdt.transpose(1, 2), n_head=2)
    deq = kq.float() * ks[..., None, :]
    assert _rel_err(deq, kq2.float() * ks2[..., None, :]) <= TOL


@pytest.mark.parametrize("cross_mode,kernel", [
    ("einsum_q8", "K2"), ("pallas_q8dt", "K2"), ("einsum_q8i", None),
    ("einsum_q4", None), ("einsum", None)])
def test_full_cross_modes_on_card(gen, tmp_path, cross_mode, kernel):
    """whisper_full at small widths in bf16 over a q5_0 file in the cross
    modes beside the default: K1 and K3 always, K2 for the int8
    modes whose step is K2's function."""
    dims = (51865, 64, 128, 2, 2, 48, 128, 2, 3, 80)
    hp = dict(zip(ggml_writer.HPARAM_KEYS, dims))
    path = str(tmp_path / "q5_0.bin")
    ggml_writer.write_random_model(
        path, hp, mel_filterbank(80), synthetic_vocab(dims[0]).id_to_token[
            :50257], "q5_0", seed=1)
    ctx = WhisperContext.from_file(path, cross_mode=cross_mode)
    assert ctx.device.type == "cuda"
    p = full_default_params()
    p.print_progress = False
    p.temperature_inc = 0.0
    p.max_tokens = 16
    pcm = (np.random.RandomState(0).randn(16000 * 5) * 0.1).astype(
        np.float32)
    for fn in (ea.self_attention, qm.quantized_matmul,
               xa.cross_attention_decode_q8dt):
        fn.launches = 0
    assert ctx.full(p, pcm) == 0
    torch.cuda.synchronize()
    assert ea.self_attention.launches > 0
    assert qm.quantized_matmul.launches > 0
    assert (xa.cross_attention_decode_q8dt.launches > 0) == (kernel == "K2")
    segs = ctx.result_all
    assert segs
    assert np.isfinite([t.p for s in segs for t in s.tokens]).all()


def test_batch_transcriber_q4_on_card(gen):
    """bench.py's kv=q4 serving setting: cross_kv_q4 in the batched
    encode, the q4e step in the loop."""
    dims = (51864, 32, 128, 2, 2, 48, 128, 2, 2, 80)
    ctx = WhisperContext.from_random(dims=dims, seed=1,
                                     cross_mode="einsum_q4")
    p = full_default_params()
    p.print_progress = False
    p.temperature_inc = 0.0
    p.no_timestamps = True
    p.max_tokens = 8
    bt = BatchTranscriber(ctx, batch_size=2, params=p, device_mel=True)
    rng = np.random.RandomState(0)
    streams = [(rng.randn(16000 * s) * 0.1 * 32768).clip(-32768, 32767)
               .astype(np.int16) for s in (5, 9)]
    result = bt.transcribe(streams)
    torch.cuda.synchronize()
    for segs in result:
        assert segs
        assert np.isfinite([t.p for s in segs for t in s.tokens]).all()
