"""Kernels K1-K7 on the card against their plain PyTorch versions (K1 and
K6 also at ragged lengths, pad keys of 1e4, batch 4, and for determinism), the
serving slice through K1 and K2 (and in 4-bit cross-KV), from_file + full
over block-quantized files through K1, K3 and K2, K4 or K5 in every cross
mode, the encoder's attention variants through K1 and K6, the encoder
block's five row-wise epilogue kernels and the fused encode, and the
tracer's clock and waits (utils/trace.py).  Every test
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
from whisper_tpu_torch.utils.trace import TRACE, Tracer  # noqa: E402
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
    as K3 on x cast to the compute dtype first, and the bias added by the
    epilogue's plain version then gives the same sum."""
    from whisper_tpu_torch.ops import encoder_epilogue as ee
    codes, scales, offs = _packed(gen, 768, 3072, True)
    x = torch.randn(M, 1, 768, generator=gen, device="cuda")
    b = torch.randn(3072, generator=gen, device="cuda")
    w = {"q": codes, "s": scales, "m": offs}
    for cd in (torch.bfloat16, torch.float32):
        got = wm._linear(x, w, cd)
        y = qm.quantized_matmul(x[:, 0].to(cd), codes, scales, offs)
        assert torch.equal(got, y[:, None])
        got, = ee.bias_cast_ref((got, b), dtype=torch.float32)
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
    """The plain block's projections (`_linear`, then bias_cast_ref): the
    bf16 product widened, plus the f32 bias, rounded once to out_dtype in
    the add, bit for bit what a separate widening, add and cast give."""
    from whisper_tpu_torch.ops import encoder_epilogue as ee
    x = torch.randn(300, 256, generator=gen, device="cuda")
    w = _bf16_randn(gen, 384, 256)
    b = torch.randn(384, generator=gen, device="cuda")
    got, = ee.bias_cast_ref((wm._linear(x, w, torch.bfloat16), b),
                            dtype=out_dtype)
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


@pytest.mark.parametrize("device_mel", [True, False], ids=["pool", "host"])
def test_continuous_batcher_on_card(gen, device_mel):
    """ContinuousBatcher on the card (einsum_q8: K1 and K2), two streams
    over two slots with the iteration hook holding the first iteration
    until both are queued, so that each batch holds the rows transcribe's
    does: the segments equal BatchTranscriber.transcribe's of the same
    streams, and with device_mel every stream held a row of the resident
    pool."""
    import threading

    from whisper_tpu_torch.parallel.batch import ContinuousBatcher
    dims = (51865, 64, 128, 2, 2, 48, 128, 2, 3, 80)
    ctx = WhisperContext.from_random(dims=dims, seed=2,
                                     cross_mode="einsum_q8")
    p = full_default_params()
    p.print_progress = False
    p.language = "en"
    p.temperature_inc = 0.0
    p.max_tokens = 8
    rng = np.random.RandomState(0)
    streams = [(rng.randn(16000 * s) * 0.1 * 32768).clip(-32768, 32767)
               .astype(np.int16) for s in (35, 9)]
    want = BatchTranscriber(ctx, batch_size=2, params=p,
                            device_mel=device_mel).transcribe(streams)
    eng = ContinuousBatcher(ctx, batch_size=2, params=p,
                            device_mel=device_mel)
    rows = []
    orig = eng.bt._iterate

    def spy(states, batch, pcm_dev=None):
        rows.extend(states[i].pcm_row for i in batch)
        return orig(states, batch, pcm_dev)

    eng.bt._iterate = spy
    parked, go = threading.Event(), threading.Event()

    def hook(n):   # the idle engine waits here while the streams queue
        parked.set()
        go.wait(timeout=60)

    eng.iteration_hook = hook
    ea.self_attention.launches = xa.cross_attention_decode_q8dt.launches = 0
    try:
        assert parked.wait(timeout=60)
        jobs = [eng.submit_async(pcm) for pcm in streams]
        go.set()
        for j in jobs:
            assert j.done.wait(timeout=300) and j.error is None, j.error
    finally:
        eng.close()
    got = [j.st.result_all for j in jobs]
    assert ([[(s.t0, s.t1, [t.id for t in s.tokens]) for s in x]
             for x in got] == [[(s.t0, s.t1, [t.id for t in s.tokens])
                                for s in x] for x in want])
    assert ea.self_attention.launches > 0
    assert xa.cross_attention_decode_q8dt.launches > 0
    assert (None not in rows) == device_mel
    if device_mel:
        assert eng._pool.is_cuda and len(eng._pool_free) == eng.max_active


def test_transcribe_stages_pcm_through_pinned_memory(gen):
    """Two back-to-back transcribe calls on one device_mel transcriber with
    different inputs (f32 streams over 4 rows, then int16 over 2): each
    call's resident stack goes through the one pinned staging buffer
    (`pcm_staged` once a call, with the stack's bytes), and every segment
    equals that of the same calls with RESIDENT_BYTES = 0, which upload
    each iteration's windows."""
    dims = (51864, 32, 128, 2, 2, 48, 128, 2, 2, 80)
    ctx = WhisperContext.from_random(dims=dims, seed=1, device="cuda")
    p = full_default_params()
    p.print_progress = False
    p.language = "en"
    p.temperature_inc = 0.0
    p.no_timestamps = True
    p.max_tokens = 8
    rng = np.random.RandomState(0)
    calls = [[(rng.randn(16000 * s) * 0.1).astype(np.float32)
              for s in (12, 40, 3)],
             [(rng.randn(16000 * s) * 0.1 * 32768).clip(-32768, 32767)
              .astype(np.int16) for s in (35, 9)]]
    bt = BatchTranscriber(ctx, batch_size=2, params=p, device_mel=True)
    streamed = BatchTranscriber(ctx, batch_size=2, params=p, device_mel=True)
    streamed.RESIDENT_BYTES = 0
    TRACE.drain()
    TRACE.enable()
    try:
        got = [bt.transcribe(calls[0])]
        ptr = bt._stage.data_ptr()
        got.append(bt.transcribe(calls[1]))
        torch.cuda.synchronize()
        staged = [r.value for r in TRACE.drain() if r.name == "pcm_staged"]
        want = [streamed.transcribe(x) for x in calls]
        assert not [r for r in TRACE.drain() if r.name == "pcm_staged"]
    finally:
        TRACE.disable()
        TRACE.drain()
    assert bt._stage.is_pinned() and bt._stage.data_ptr() == ptr
    # 4 f32 rows, then 2 int16 rows, of 90 s (40 s and its 30 s of
    # padding rounded up to 30 s multiples; 35 s likewise)
    assert staged == [4 * 90 * 16000 * 4, 2 * 90 * 16000 * 2]
    for g, w in zip(got, want):
        assert all(g)
        assert ([[(s.t0, s.t1, [t.id for t in s.tokens]) for s in x]
                 for x in g] == [[(s.t0, s.t1, [t.id for t in s.tokens])
                                  for s in x] for x in w])


def test_server_round_trip_on_card(gen, tmp_path):
    """The port's server in this process over a small q5_0 file on the card
    with --batch 2 (K1 and K3): a json and a verbose_json request answer
    200, the words carry token timestamps."""
    import io
    import json
    import socket
    import threading
    import urllib.request
    import wave
    from http.server import ThreadingHTTPServer

    import whisper_tpu_torch.server as srv
    dims = (51865, 64, 128, 2, 2, 48, 128, 2, 3, 80)
    hp = dict(zip(ggml_writer.HPARAM_KEYS, dims))
    path = str(tmp_path / "q5_0.bin")
    ggml_writer.write_random_model(
        path, hp, mel_filterbank(80), synthetic_vocab(dims[0]).id_to_token[
            :50257], "q5_0", seed=1)
    srv.STATE.ctx = WhisperContext.from_file(path)
    srv.STATE.batcher = srv._BatchWorker(srv.STATE.ctx, batch_size=2)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.random.RandomState(1).randn(16000 * 8) * 3000)
                      .astype(np.int16).tobytes())
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    httpd = ThreadingHTTPServer(("127.0.0.1", port), srv.Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    ea.self_attention.launches = qm.quantized_matmul.launches = 0
    try:
        for fmt in ("json", "verbose_json"):
            body = (b'--b\r\nContent-Disposition: form-data; name="file"; '
                    b'filename="a.wav"\r\n\r\n' + buf.getvalue()
                    + b'\r\n--b\r\nContent-Disposition: form-data; '
                    b'name="response_format"\r\n\r\n' + fmt.encode()
                    + b"\r\n--b--\r\n")
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/inference", data=body,
                headers={"Content-Type": "multipart/form-data; boundary=b"})
            with urllib.request.urlopen(req, timeout=300) as r:
                assert r.status == 200
                doc = json.loads(r.read())
            assert doc["text"]
        words = [w for s in doc["segments"] for w in s.get("words", [])]
        assert words and any(w["start"] != -0.01 for w in words)
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.STATE.batcher.close()
        srv.STATE.batcher = srv.STATE.ctx = None
    assert ea.self_attention.launches > 0
    assert qm.quantized_matmul.launches > 0


@pytest.mark.parametrize("form", ["dense", "q8"])
def test_decode_prompt_cross_qk_on_card(gen, form):
    """The DTW re-decode's teacher-forced pass (packed linears through K3
    at M = B x T_pad) in bf16 on the card against f32 on the CPU (plain
    versions), at large-v3's widths cut to 2 + 2 layers: logits and the
    captured cross-attention within the model checks' 5e-2."""
    from whisper_tpu_torch.dtw import head_select_matrix
    from whisper_tpu_torch.weights.convert import random_params
    dims = list(wm.MODEL_DIMS["large-v3"])
    dims[4] = dims[8] = 2
    cfg = wm.WhisperConfig(*dims, model_type="large-v3-2+2")
    params = random_params(cfg, seed=3, dtype=torch.bfloat16, device="cuda")

    def to_cpu(tree):
        return {k: to_cpu(v) if isinstance(v, dict) else v.float().cpu()
                for k, v in tree.items()}

    B, T, L, H = 2, 64, cfg.n_text_layer, cfg.n_text_head
    kc, vc = ((torch.randn(L, B, H, 64, cfg.n_audio_ctx, generator=gen,
                           device="cuda") * 0.5).to(torch.bfloat16)
              for _ in range(2))
    if form == "q8":
        kc, vc = (("q8",) + xa.quantize_kv_bhdt(x) for x in (kc, vc))
    sel = head_select_matrix([(0, 3), (1, 7), (1, 0)], L, H)
    toks = torch.randint(0, 50000, (B, T), generator=gen, device="cuda")
    out = {}
    for dev, cd, p in (("cuda", torch.bfloat16, params),
                       ("cpu", torch.float32, to_cpu(params))):
        move = (lambda x: x.to(dev) if isinstance(x, torch.Tensor)
                else (x[0],) + tuple(a.to(dev) for a in x[1:]))
        with torch.no_grad():
            lg, qk = wm.decode_prompt_cross_qk(
                p, toks.to(dev), torch.arange(T, device=dev), move(kc),
                move(vc), n_head=H, head_select=sel,
                self_mask=wm.make_causal_mask(T, device=dev),
                compute_dtype=cd)
        out[dev] = (lg.float().cpu(), qk.float().cpu())
    for got, ref in zip(out["cuda"], out["cpu"]):
        assert got.shape == ref.shape and torch.isfinite(got).all()
        assert _rel_err(got, ref) <= 5e-2
    assert out["cuda"][1].shape == (L, B, 2, T, cfg.n_audio_ctx)


def test_native_grammar_matches_python_on_card_host(gen):
    """The native grammar engine, built on the card's host, against the
    Python engine: the same masks and accepts over a vocab with
    grammars/colors.gbnf's pieces in it."""
    import os
    from whisper_tpu_torch import grammar as gr
    from whisper_tpu_torch.weights.vocab import Vocab
    if gr._load_native() is None:
        pytest.fail("the native grammar engine did not build")
    src = open(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "grammars", "colors.gbnf")).read()
    toks = [b" t%d" % i for i in range(4000)]
    toks[1000:1009] = [b" ", b"red", b" red", b" and ", b" and", b"and ",
                       b"green", b" green", b"blue and "]
    vocab = Vocab(n_vocab=4001, id_to_token=toks + [b"<eot>"],
                  token_to_id={t: i for i, t in enumerate(toks)},
                  token_eot=4000)
    rules, symbols = gr.parse_gbnf(src)
    engines = [gr.Grammar(rules, symbols["root"]),
               gr.NativeGrammar(rules, symbols["root"])]
    rng = np.random.RandomState(0)
    for _ in range(8):
        masks = []
        for g in engines:
            m = np.zeros(vocab.n_vocab, np.float32)
            g.suppress_invalid(vocab, m, 100.0)
            masks.append(m)
        np.testing.assert_array_equal(masks[1], masks[0])
        allowed = np.nonzero(masks[0][:vocab.token_eot] == 0)[0]
        if not len(allowed):
            break
        tok = int(rng.choice(allowed))
        for g in engines:
            g.accept_token(vocab, tok)


def test_stream_vad_step_on_card(gen, tmp_path):
    """One VAD step of whisper-stream at audio_ctx = 750 over a q5_0 file
    (pallas_q8: K1 at T = 750, K3, K5 at Ta = 750) equals the same `full`
    called directly; the card's host builds the native mel for it."""
    from whisper_tpu_torch.audio import native
    from whisper_tpu_torch.stream import StreamTranscriber
    assert native.available(), "the native audio front end did not build"
    dims = (51865, 1500, 128, 2, 2, 48, 128, 2, 3, 80)
    hp = dict(zip(ggml_writer.HPARAM_KEYS, dims))
    path = str(tmp_path / "q5_0.bin")
    ggml_writer.write_random_model(
        path, hp, mel_filterbank(80), synthetic_vocab(dims[0]).id_to_token[
            :50257], "q5_0", seed=1)
    ctx = WhisperContext.from_file(path, device="cuda",
                                   cross_mode="pallas_q8")
    t = np.arange(2 * 16000) / 16000
    pcm = np.concatenate([
        (0.3 * np.sin(2 * np.pi * 440 * t)
         + np.random.RandomState(4).randn(len(t)) * 0.05),
        np.zeros(16000)]).astype(np.float32)
    st = StreamTranscriber(ctx, step_ms=0, audio_ctx=750, max_tokens=16)
    for fn in (ea.self_attention, xa.cross_attention_decode_q8):
        fn.launches = 0
    segs = st.feed_vad(pcm[-2 * 16000:], pcm)
    torch.cuda.synchronize()
    assert segs and ctx.exp_n_audio_ctx == 750
    assert ea.self_attention.launches > 0
    assert xa.cross_attention_decode_q8.launches > 0
    want = [(s.t0, s.t1, s.text, [t.id for t in s.tokens])
            for s in ctx.result_all]
    assert ctx.full(st.params, pcm) == 0
    assert [(s.t0, s.t1, s.text, [t.id for t in s.tokens])
            for s in ctx.result_all] == want
    assert segs == [(t0, t1, text) for t0, t1, text, _ in want]


def test_trace_clock_is_the_profilers(gen):
    """A span (time.time_ns()) fenced around one K2 launch holds the
    kernel's start and end as torch.profiler's device events give them,
    within 50 us: one clock, as the benchmark's idle-gap attribution
    assumes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    shape = (4, 20, 64, 1500)
    q = (torch.randn(4, 20, 1, 64, generator=gen, device="cuda") * 0.3
         ).to(torch.bfloat16)
    kq, ks = xa.quantize_kv_bhdt(
        torch.randn(shape, generator=gen, device="cuda") * 0.3)
    vq, vs = xa.quantize_kv_bhdt(
        torch.randn(shape, generator=gen, device="cuda") * 0.3)
    xa.cross_attention_decode_q8dt(q, kq, ks, vq, vs)     # built and warm
    torch.cuda.synchronize()
    tr = Tracer()
    tr.enable()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with tr.span("k2"):
            xa.cross_attention_decode_q8dt(q, kq, ks, vq, vs)
            torch.cuda.synchronize()
    (span,) = tr.drain()
    (k2,) = [e for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA
             and "xattn_q8dt" in e.name()]
    print(f"span {span.t0}..{span.t1}, K2 {k2.start_ns()}..{k2.end_ns()} "
          f"(start - t0 {k2.start_ns() - span.t0} ns, t1 - end "
          f"{span.t1 - k2.end_ns()} ns)")
    slack = 50_000
    assert span.t0 - slack <= k2.start_ns() < k2.end_ns() <= span.t1 + slack


def test_decode_window_waits_only_in_wait_spans(gen):
    """One window decode under torch's sync debug mode: every call that
    waits for the device (each warns) comes while a `wait` span is open
    on its thread, so the `step` spans (dispatch_ms.batch) hold no wait."""
    import threading
    import time
    import warnings
    dims = (51864, 32, 128, 2, 2, 48, 128, 2, 2, 80)
    ctx = WhisperContext.from_random(dims=dims, seed=1, device="cuda")
    p = full_default_params()
    p.print_progress = False
    p.language = "en"
    p.temperature_inc = 0.0
    p.no_timestamps = True
    p.max_tokens = 8
    bt = BatchTranscriber(ctx, batch_size=2, params=p, device_mel=True)
    bt.warmup(pcm_dtype=np.int16)
    rng = np.random.RandomState(0)
    windows = (rng.randn(2, 2 * 1500 * 160 + 400) * 3000).astype(np.int16)
    kc, vc = bt._encode_local(windows)
    live = np.ones((2,), bool)
    seeks = np.zeros((2,), np.int32)
    ends = np.full((2,), 3000, np.int32)
    keys = np.zeros((2, 2), np.uint32)
    torch.cuda.synchronize()
    seen = []

    def show(message, category, *args, **kwargs):
        # one warning a synchronizing call (and one notice as the mode
        # is set, which is not one)
        if "called a synchronizing CUDA operation" in str(message):
            seen.append((time.time_ns(), threading.get_ident(),
                         str(message)))

    TRACE.drain()
    TRACE.enable()
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = bt._decode_rows([list(bt.prompt_init)] * 2, kc, vc,
                                      live, seeks, ends, 0.0, keys)
            finally:
                torch.cuda.set_sync_debug_mode(0)
    finally:
        TRACE.disable()
        recs = TRACE.drain()
    waits = [r for r in recs if r.name == "wait"]
    n_tokens = int(out["n_tokens"])
    assert n_tokens >= 2 and len(waits) == n_tokens + 2
    assert sum(r.name == "step" for r in recs) == n_tokens - 1
    outside = [(msg, [r.name for r in recs if r.t0 <= t <= r.t1])
               for t, thread, msg in seen
               if not any(w.thread == thread and w.t0 <= t <= w.t1
                          for w in waits)]
    assert len(seen) >= len(waits) and not outside, outside[:5]


# the encoder block's row-wise epilogues (ops/encoder_epilogue.py): rows of
# one window, a few, one, and the batch cells' 256 windows
EPILOGUE_ROWS = (1, 17, 1500, 256 * 1500)


def _epilogue_pairs(gen, kernel, rows, D):
    """One call of `kernel` at (rows, D) and its plain version on the same
    inputs -> [(kernel output, plain output, scale)]: scale None where the
    two must be equal bit for bit; for the layernorms' and GELU's bf16
    outputs, the magnitude of the f32 terms each was rounded from."""
    from whisper_tpu_torch.ops import encoder_epilogue as ee

    def randn(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale + shift

    def ln_terms(x):
        # |gamma * rstd * (x - mean)| + |beta|, from PyTorch's f32 layernorm
        return (ee._layernorm(x, w, b, ee.EPS) - b).abs() + b.abs()

    x = randn(rows, D, scale=2.0, shift=0.3)
    y = randn(rows, D).to(torch.bfloat16)
    bias = randn(D, scale=0.1)
    w, b = randn(D, scale=0.1, shift=1.0), randn(D, scale=0.1)
    n = getattr(ee, kernel).launches
    if kernel == "ln_cast":
        pairs = [(ee.ln_cast(x, w, b), ee.ln_cast_ref(x, w, b), ln_terms(x))]
    elif kernel == "bias_cast":
        y1 = randn(rows, D).to(torch.bfloat16)
        refs = ee.bias_cast_ref((y, bias), (y1, w))
        outs = ee.bias_cast((y, bias), (y1, w))
        assert outs[0] is y and outs[1] is y1
        pairs = [(o, r, None) for o, r in zip(outs, refs)]
    elif kernel == "bias_residual_ln":
        refs = ee.bias_residual_ln_ref(x, y, bias, w, b)
        outs = ee.bias_residual_ln(x, y, bias, w, b)
        pairs = [(outs[0], refs[0], None),
                 (outs[1], refs[1], ln_terms(refs[0]))]
    elif kernel == "bias_gelu_cast":
        ref = ee.bias_gelu_cast_ref(y, bias)
        terms = (y.float() + bias).abs()
        assert ee.bias_gelu_cast(y, bias) is y
        pairs = [(y, ref, terms)]
    else:
        pairs = [(ee.bias_residual(x, y, bias), ee.bias_residual_ref(x, y, bias),
                  None)]
    torch.cuda.synchronize()
    assert getattr(ee, kernel).launches == n + 1
    return pairs


@pytest.mark.parametrize("kernel,D", [
    (k, d) for k in ("ln_cast", "bias_cast", "bias_residual_ln",
                     "bias_residual") for d in (384, 1280)]
    + [("bias_gelu_cast", d) for d in (4 * 384, 4 * 1280)])
def test_epilogue_kernels_match_plain_on_card(gen, kernel, D):
    """Each kernel against its plain version at rows 1, 17, 1500 and
    256 x 1500: the bias casts, the residual sums and bias_residual_ln's x'
    bit for bit; the layernorms' and GELU's bf16 outputs equal in >= 99.99%
    of the elements of all four row counts together, and the others within
    one bf16 ulp of the f32 terms they were rounded from (the layernorms
    sum their mean and variance in another order than PyTorch's Welford,
    so their f32 results differ by a few f32 ulps of |gamma x_hat| +
    |beta|: where the two terms cancel, that is many ulps of the small
    output itself; GELU's tanhf may be compiled otherwise).  On an H100
    80GB HBM3 the worst reading was 99.99777% equal (ln_cast, D 384), the
    others exactly one ulp of their terms; GELU equal bit for bit."""
    n_out = n_diff = 0
    worst = 0.0
    for rows in EPILOGUE_ROWS:
        for got, want, terms in _epilogue_pairs(gen, kernel, rows, D):
            assert got.shape == want.shape and got.dtype == want.dtype
            if terms is None:
                assert torch.equal(got, want), (kernel, rows, D)
                continue
            assert torch.isfinite(got).all()
            n_out += got.numel()
            for i in range(0, rows, 32768):
                g, r = got[i:i + 32768].float(), want[i:i + 32768].float()
                ulp = torch.exp2(torch.floor(torch.log2(terms[i:i + 32768]))
                                 - 7)
                gap = (g - r).abs()
                n_diff += int((gap > 0).sum())
                worst = max(worst, float((gap / ulp).nan_to_num(0).max()))
            del got, want, terms
        torch.cuda.empty_cache()
    if n_out:
        share = 1 - n_diff / n_out
        print(f"{kernel} D {D}: {n_diff} of {n_out} bf16 outputs differ, "
              f"{100 * share:.5f}% equal; worst {worst:.3f} bf16 ulps of "
              "their terms")
        assert share >= 0.9999 and worst <= 1, (n_diff, n_out, worst)


def test_encode_fused_epilogues_on_card(gen, monkeypatch):
    """One encode at large-v3's widths (1280, 20 heads, 128 mels) cut to 4
    layers, B 2: the fused sequence against the plain one on the card
    (`_on_card` patched off, so the one rule `_kernels` says plain), within
    TOL (bf16 with one-ulp layernorm differences carried through 4 layers;
    it read 5.3e-3 on an H100 80GB HBM3); each kernel launched once a
    layer, the six products a layer through `_linear` either way, and
    neither the plain GELU nor the plain layernorm run in the blocks."""
    from whisper_tpu_torch.ops import encoder_epilogue as ee
    from whisper_tpu_torch.weights.convert import random_params
    dims = list(wm.MODEL_DIMS["large-v3"])
    dims[4], dims[8] = 4, 1
    cfg = wm.WhisperConfig(*dims)
    params = random_params(cfg, seed=5, dtype=torch.bfloat16, device="cuda")
    mel = torch.randn(2, 2 * cfg.n_audio_ctx, cfg.n_mels, generator=gen,
                      device="cuda")
    names = ("ln_cast", "bias_cast", "bias_residual_ln", "bias_gelu_cast",
             "bias_residual")
    calls = {"_linear": 0, "_gelu": 0, "_layernorm": 0}
    for name in calls:
        def spy(*args, _fn=getattr(wm, name), _name=name, **kw):
            calls[_name] += 1
            return _fn(*args, **kw)
        monkeypatch.setattr(wm, name, spy)
    n = {k: getattr(ee, k).launches for k in names}
    with torch.no_grad():
        fused = wm.encode(params, mel, n_head=cfg.n_audio_head)
        torch.cuda.synchronize()
        assert {k: getattr(ee, k).launches - n[k] for k in names} == \
            dict.fromkeys(names, cfg.n_audio_layer)
        # the conv stem's two GELUs and ln_post
        assert calls == {"_linear": 6 * cfg.n_audio_layer, "_gelu": 2,
                         "_layernorm": 1}
        monkeypatch.setattr(wm, "_on_card", lambda x: False)
        plain = wm.encode(params, mel, n_head=cfg.n_audio_head)
    assert calls == {"_linear": 12 * cfg.n_audio_layer, "_gelu": 4,
                     "_layernorm": 2}
    err = _rel_err(fused, plain)
    print(f"encode fused vs plain, large-v3 widths x 4 layers: rel {err:.3e}")
    assert err <= TOL


def test_epilogue_wrappers_refuse_on_card(gen):
    """Wrong dtype, shape, width, contiguity or alignment raise before a
    launch; the C entry points refuse what they do not take, and the
    wrapper's launch check raises on it."""
    from whisper_tpu_torch.ops import encoder_epilogue as ee
    from whisper_tpu_torch.ops._build import library
    x = torch.randn(4, 64, generator=gen, device="cuda")
    w, b = torch.ones(64, device="cuda"), torch.zeros(64, device="cuda")
    y = x.to(torch.bfloat16)
    odd = torch.zeros(x.numel() + 1, device="cuda")[1:].view(4, 64)
    wide = torch.zeros(1, 2056, device="cuda")
    for call in (lambda: ee.ln_cast(y, w, b),                 # dtype
                 lambda: ee.ln_cast(x, w.to(torch.bfloat16), b),
                 lambda: ee.ln_cast(x, w[:32], b),            # shape
                 lambda: ee.ln_cast(x.t(), w[:4], b[:4]),     # contiguity
                 lambda: ee.ln_cast(odd, w, b),               # alignment
                 lambda: ee.ln_cast(x[:, :12].contiguous(), w[:12], b[:12]),
                 lambda: ee.ln_cast(wide, wide[0], wide[0]),  # past 2048
                 lambda: ee.bias_cast((y, b), (y[:2], b)),
                 lambda: ee.bias_cast((y, b), (y, b), (y, b)),
                 lambda: ee.bias_residual_ln(x, x, b, w, b),
                 lambda: ee.bias_gelu_cast(x, b),
                 lambda: ee.bias_residual(x, y[:2], b)):
        with pytest.raises(ValueError):
            call()
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty(4, 2056, dtype=torch.bfloat16, device="cuda")
    for entry, args in (
            ("wtt_ln_cast", (x.data_ptr(), w.data_ptr(), b.data_ptr(),
                             out.data_ptr(), 4, 12, 1e-5, stream)),
            ("wtt_ln_cast", (x.data_ptr(), w.data_ptr(), b.data_ptr(),
                             out.data_ptr(), 1, 2056, 1e-5, stream)),
            ("wtt_bias_cast", (y.data_ptr(), b.data_ptr(), y.data_ptr(),
                               b.data_ptr(), 3, 4, 64, stream)),
            ("wtt_bias_gelu_cast", (y.data_ptr(), b.data_ptr(), 0, 64,
                                    stream)),
            ("wtt_bias_residual", (x.data_ptr(), y.data_ptr(), b.data_ptr(),
                                   out.data_ptr(), 4, 60, stream))):
        with pytest.raises(RuntimeError):
            library().call(entry, *args)


# the decode step's self-attention over its cache (ops/decoder_attention.py)
# at rows 1, 16 and the batch cells' 256, over a cache of 293 columns (72
# prompt slots, 220 tokens and one); pads as the carried prompts leave them
STEP_C = 293
# its bf16 outputs against the plain step's: the same roundings in another
# order, so a score within an f32 rounding of a bf16 tie rounds the other
# way now and then, and with it the weights.  On an H100 80GB HBM3 the
# worst readings were 99.979% equal (B 256, no pads) and 0.5 bf16 ulps of
# the terms; without the weights' bf16 rounding most outputs move
STEP_EQUAL = 0.999
STEP_ULPS = 1


def _self_attn_inputs(gen, B, H=20, Dh=64, C=STEP_C):
    D = H * Dh
    qkv = torch.randn(B, 3 * D, generator=gen,
                      device="cuda").to(torch.bfloat16)
    caches = [torch.randn(B, H, Dh, C, generator=gen,
                          device="cuda").to(torch.bfloat16) for _ in range(2)]
    q_b, v_b = (torch.randn(D, generator=gen, device="cuda") * 0.3
                for _ in range(2))
    return qkv, q_b, v_b, caches


@pytest.mark.parametrize("padded", [False, True], ids=["nopad", "pad"])
@pytest.mark.parametrize("B", [1, 16, 256])
def test_self_attn_step_matches_plain_on_card(gen, B, padded):
    """The kernel against its plain version at kv_len 1, 72 (the prompt),
    136 (64 tokens on) and the whole cache, with pad lengths 0-63 or none:
    q and v written back and the two cache columns bit for bit; the
    outputs equal in >= STEP_EQUAL of the elements of all four together,
    the others within STEP_ULPS bf16 ulps of the magnitude sum
    sum_j w_j |v_j| they were rounded from."""
    from whisper_tpu_torch.ops import decoder_attention as da
    H, Dh = 20, 64
    n_out = n_diff = 0
    worst = 0.0
    for kv_len in (1, 72, 136, STEP_C):
        qkv, q_b, v_b, caches = _self_attn_inputs(gen, B)
        pad = ((torch.arange(B, device="cuda") * 37 % 64).clamp_max(
            kv_len - 1) if padded else None)
        ref_qkv = qkv.clone()
        ref_caches = [c.clone() for c in caches]
        ci = kv_len - 1
        want = da.self_attn_step_ref(ref_qkv, q_b, v_b, *ref_caches, ci,
                                     kv_len, pad, H)
        n = da.self_attn_step.launches
        got = da.self_attn_step(qkv, q_b, v_b, *caches, ci, kv_len, pad, H)
        torch.cuda.synchronize()
        assert da.self_attn_step.launches == n + 1
        assert torch.equal(qkv, ref_qkv)
        for c, r in zip(caches, ref_caches):
            assert torch.equal(c, r)
        assert got.shape == want.shape and got.dtype == torch.bfloat16
        assert torch.isfinite(got).all()
        # the magnitude sum each output was rounded from, from the plain
        # version's weights
        D = H * Dh
        q = ref_qkv[:, :D].reshape(B, H, 1, Dh).float()
        mask = da.step_mask(STEP_C, kv_len, pad, "cuda")
        w = torch.softmax(torch.matmul(q, ref_caches[0].float())
                          * Dh ** -0.5 + mask, dim=-1)
        terms = torch.matmul(w, ref_caches[1].float().abs().transpose(-1, -2))
        terms = terms.reshape(B, D)
        ulp = torch.exp2(torch.floor(torch.log2(terms)) - 7)
        gap = (got.float() - want.float()).abs()
        n_out += got.numel()
        n_diff += int((gap > 0).sum())
        worst = max(worst, float((gap / ulp).max()))
    share = 1 - n_diff / n_out
    print(f"self_attn_step B {B} pad {padded}: {n_diff} of {n_out} bf16 "
          f"outputs differ, {100 * share:.5f}% equal; worst {worst:.3f} bf16 "
          "ulps of their terms")
    assert share >= STEP_EQUAL and worst <= STEP_ULPS, (n_diff, n_out, worst)


def test_decode_step_fused_on_card(gen, monkeypatch):
    """large-v3's decoder (32 layers, 1280 wide, 20 heads) at B 16 over
    int8 cross-KV (K2): a 68-token prompt (pads 0-4), then 10 steps fused
    and plain (`_on_card` patched off, so the one rule `_kernels` says
    plain) from the same cache, teacher-forced
    with the same tokens: the logits within TOL of the plain ones at every
    step (bf16 with one-ulp layernorm and rounding-flip differences
    through 32 layers; the reading is printed); each kernel launched once
    a layer (ln_cast once a step) and neither `_linear` nor the plain
    GELU or layernorm run in the layers."""
    from whisper_tpu_torch.decode.loop import prompt_mask
    from whisper_tpu_torch.ops import decoder_attention as da
    from whisper_tpu_torch.ops import encoder_epilogue as ee
    from whisper_tpu_torch.weights.convert import random_params
    dims = list(wm.MODEL_DIMS["large-v3"])
    dims[4] = 1
    cfg = wm.WhisperConfig(*dims)
    params = random_params(cfg, seed=5, dtype=torch.bfloat16, device="cuda")
    L, H, D = cfg.n_text_layer, cfg.n_text_head, cfg.n_text_state
    Dh, B, P, N, Ta = D // H, 16, 68, 10, 1500
    kc, vc = (("q8e",
               torch.randint(-127, 128, (L, B, H, Dh, Ta), generator=gen,
                             device="cuda", dtype=torch.int8),
               torch.rand(L, B, H, Ta, generator=gen, device="cuda") * 0.03)
              for _ in range(2))
    pad = torch.arange(B, device="cuda") % 5
    prompt = torch.randint(0, 50000, (B, P), generator=gen, device="cuda")
    steps = torch.randint(0, 50000, (N, B), generator=gen, device="cuda")
    positions, mask = prompt_mask(pad, P)
    with torch.no_grad():
        _, k_self, v_self = wm.decode_prompt(
            params, prompt, positions, ("q8",) + kc[1:], ("q8",) + vc[1:], H,
            self_mask=mask)
    C = P + N + 1
    cache0 = {}
    for name, kv in (("k", k_self), ("v", v_self)):
        cache0[name] = torch.zeros((L, B, H, Dh, C), dtype=torch.bfloat16,
                                   device="cuda")
        cache0[name][..., :P] = kv.permute(0, 1, 3, 4, 2)

    names = ("ln_cast", "bias_cast", "bias_residual_ln", "bias_gelu_cast")
    calls = {"_linear": 0, "_gelu": 0, "_layernorm": 0}
    for name in calls:
        def spy(*args, _fn=getattr(wm, name), _name=name, **kw):
            calls[_name] += 1
            return _fn(*args, **kw)
        monkeypatch.setattr(wm, name, spy)

    def run():
        cache = {n: c.clone() for n, c in cache0.items()}
        out = []
        with torch.no_grad():
            for i in range(N):
                logits, cache = wm.decode_step(
                    params, steps[i], P - pad + i, P + i, cache, kc, vc,
                    kv_len=P + i + 1, n_head=H, pad_len=pad)
                out.append(logits)
        return torch.stack(out), cache

    n = {k: getattr(ee, k).launches for k in names}
    n_attn = da.self_attn_step.launches
    fused, fused_cache = run()
    torch.cuda.synchronize()
    assert {k: getattr(ee, k).launches - n[k] for k in names} == {
        "ln_cast": N, "bias_cast": N * L, "bias_residual_ln": 3 * N * L,
        "bias_gelu_cast": N * L}
    assert da.self_attn_step.launches - n_attn == N * L
    assert calls == {"_linear": 0, "_gelu": 0, "_layernorm": 0}
    monkeypatch.setattr(wm, "_on_card", lambda x: False)
    plain, plain_cache = run()
    assert calls["_linear"] == 8 * N * L
    errs = [_rel_err(f, p) for f, p in zip(fused, plain)]
    cache_err = max(_rel_err(fused_cache[n][..., P:].float(),
                             plain_cache[n][..., P:].float())
                    for n in ("k", "v"))
    print(f"decode_step fused vs plain, large-v3 x 32 layers, B {B}: logits "
          f"rel {max(errs):.3e} (by step {[f'{e:.2e}' for e in errs]}), "
          f"new cache columns rel {cache_err:.3e}")
    assert max(errs) <= TOL and cache_err <= TOL


def test_self_attn_step_refuses_on_card(gen):
    """Wrong dtype, shape, contiguity, head width, cache column or key
    count raise before a launch; the C entry point refuses what it does
    not take, and the wrapper's launch check raises on it."""
    from whisper_tpu_torch.ops import decoder_attention as da
    from whisper_tpu_torch.ops._build import library
    B, H, Dh, C = 2, 4, 64, 16
    qkv, q_b, v_b, (kc, vc) = _self_attn_inputs(gen, B, H, Dh, C)
    pad = torch.zeros(B, dtype=torch.long, device="cuda")
    good = [qkv, q_b, v_b, kc, vc, 3, 4, pad, H]

    def with_(i, val):
        args = list(good)
        args[i] = val
        return args
    for args in (with_(0, qkv.float()),                       # dtype
                 with_(0, qkv[..., :-8]),                     # shape
                 with_(1, q_b.to(torch.bfloat16)),
                 with_(3, kc.float()),
                 with_(4, vc[..., :-1].contiguous()),         # C differs
                 with_(3, kc.transpose(0, 1).contiguous().transpose(0, 1)),
                 with_(7, pad.int()),
                 with_(7, pad[:1].expand(B)),                 # contiguity
                 with_(5, C), with_(5, -1),                   # cache column
                 with_(6, 0), with_(6, C + 1),                # keys
                 with_(8, 3)):                                # D % heads
        with pytest.raises(ValueError):
            da.self_attn_step(*args)
    wide = _self_attn_inputs(gen, 1, 2, 128, 8)               # Dh 128
    with pytest.raises(ValueError):
        da.self_attn_step(wide[0], wide[1], wide[2], *wide[3], 0, 1, None, 2)
    out = torch.empty(B, H * Dh, dtype=torch.bfloat16, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = (qkv.data_ptr(), q_b.data_ptr(), v_b.data_ptr(), kc.data_ptr(),
            vc.data_ptr(), 0, out.data_ptr())
    for shape in ((B, H, 65, C, 0, 1), (B, H, Dh, C, C, 1),
                  (B, H, Dh, C, 0, C + 1), (B, H, Dh, C, 0, 0),
                  (0, H, Dh, C, 0, 1)):
        with pytest.raises(RuntimeError):
            library().call("wtt_self_attn_step", *ptrs, *shape, 0.125,
                           stream)


# one decoder layer's cross-K/V to int8 (ops/cross_attention.py
# `cross_kv_quant`): (B, Ta, H) of a few windows, of audio_ctx 750 and of
# the batch cells' 256 windows, at large-v3's 20 heads and at the 10 a rank
# of a two-rank tensor-parallel mesh; and 5 heads (a four-rank mesh: the
# kernel's last group of 2 heads holds one) at a ragged Ta
XKV_CASES = [(B, Ta, H) for B, Ta in ((4, 1500), (3, 750), (256, 1500))
             for H in (20, 10)] + [(2, 37, 5)]


def _xkv_rows(gen, B, Ta, H):
    """bf16 projection rows k, v (B, Ta, H * 64) and V's f32 bias, with
    all-zero segments (position 3 of head 0 of both) and segments whose
    largest magnitude is 127 (position 5 of head 1 of both), whose codes
    are their values rounded half to even; V's heads 0 and 1 have no
    bias."""
    D = H * 64
    k, v = ((torch.randn(B, Ta, D, generator=gen, device="cuda") * 2)
            .to(torch.bfloat16) for _ in range(2))
    bias = (torch.randn(D, generator=gen, device="cuda") * 0.5).to(
        torch.bfloat16).float()
    bias[:128] = 0
    ties = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5] * 8,
                        dtype=torch.bfloat16, device="cuda")
    k[:, 5, 64:128] = ties
    v[:, 5, 64:128] = ties
    k[:, 3, :64] = 0
    v[:, 3, :64] = 0
    return k, v, bias


@pytest.mark.parametrize("B,Ta,H", XKV_CASES)
def test_cross_kv_quant_matches_plain_on_card(gen, B, Ta, H):
    """The kernel's codes and scales against its plain version's, equal
    bit for bit (Ta 750 and 37 take its byte stores); one launch for K and
    V; into `out` when given, as cross_kv_q8 passes a layer's slots."""
    k, v, bias = _xkv_rows(gen, B, Ta, H)
    n = xa.cross_kv_quant.launches
    got = xa.cross_kv_quant(k, v, bias, H)
    torch.cuda.synchronize()
    assert xa.cross_kv_quant.launches == n + 1
    want = xa.cross_kv_quant_ref(k, v, bias, H)
    for (gq, gs), (wq, ws) in zip(got, want):
        assert gq.shape == (B, H, 64, Ta) and gq.dtype == torch.int8
        assert gs.shape == (B, H, Ta) and gs.dtype == torch.float32
        assert torch.equal(gq, wq) and torch.equal(gs, ws)
    del got
    stacks = [torch.full((2, B, H, 64, Ta), 7, dtype=torch.int8,
                         device="cuda") if i % 2 == 0 else
              torch.full((2, B, H, Ta), -1.0, device="cuda")
              for i in range(4)]
    xa.cross_kv_quant(k, v, bias, H, out=tuple(s[1] for s in stacks))
    torch.cuda.synchronize()
    for s, w in zip(stacks, (t for pair in want for t in pair)):
        assert torch.equal(s[1], w)
        assert (s[0] == (7 if s.dtype == torch.int8 else -1)).all()


def test_cross_kv_q8_fused_on_card(gen, monkeypatch):
    """cross_kv_q8 at large-v3's widths over its 32 decoder layers, B 2,
    V's bias nonzero: the fused path (one cross_kv_quant a layer,
    `cross_kv_fused` counted once, 32) gives the plain path's stacks bit
    for bit (`_on_card` patched off)."""
    from whisper_tpu_torch.weights.convert import random_params
    dims = list(wm.MODEL_DIMS["large-v3"])
    dims[4] = 1
    cfg = wm.WhisperConfig(*dims)
    params = random_params(cfg, seed=5, dtype=torch.bfloat16, device="cuda")
    L, D = cfg.n_text_layer, cfg.n_text_state
    params["decoder"]["blocks"]["xv_b"] = torch.randn(
        L, D, generator=gen, device="cuda") * 0.5
    enc = torch.randn(2, cfg.n_audio_ctx, D, generator=gen, device="cuda")
    n = xa.cross_kv_quant.launches
    TRACE.drain()
    TRACE.enable()
    try:
        with torch.no_grad():
            fused = wm.cross_kv_q8(params, enc, cfg.n_text_head)
            torch.cuda.synchronize()
    finally:
        TRACE.disable()
        recs = TRACE.drain()
    assert xa.cross_kv_quant.launches - n == L
    assert [r.value for r in recs if r.name == "cross_kv_fused"] == [L]
    monkeypatch.setattr(wm, "_on_card", lambda x: False)
    with torch.no_grad():
        plain = wm.cross_kv_q8(params, enc, cfg.n_text_head)
    assert xa.cross_kv_quant.launches - n == L
    for (fq, fs), (pq, ps) in zip(fused, plain):
        assert fq.shape == (L, 2, cfg.n_text_head, 64, cfg.n_audio_ctx)
        assert torch.equal(fq, pq) and torch.equal(fs, ps)


def test_cross_kv_quant_refuses_on_card(gen):
    """A non-contiguous, f32, misshapen or misaligned operand raises before
    a launch; the C entry point refuses misaligned rows, and the
    wrapper's launch check raises on it."""
    from whisper_tpu_torch.ops._build import library
    B, Ta, H = 2, 40, 2
    k, v, bias = _xkv_rows(gen, B, Ta, H)
    odd = torch.zeros(k.numel() + 1, dtype=torch.bfloat16,
                      device="cuda")[1:].view(k.shape)
    codes = torch.empty(B, H, 64, Ta, dtype=torch.int8, device="cuda")
    scales = torch.empty(B, H, Ta, device="cuda")
    n = xa.cross_kv_quant.launches
    for args, kw in (
            ((k.float(), v, bias, H), {}),                          # f32
            ((k, v.float(), bias, H), {}),
            ((k, v, bias.to(torch.bfloat16), H), {}),
            ((k.transpose(0, 1).contiguous().transpose(0, 1), v, bias, H),
             {}),                                                # contiguity
            ((k, v, bias, 3), {}),                                  # heads
            ((k, v[:, :-1], bias, H), {}),                          # shape
            ((odd, v, bias, H), {}),                                # alignment
            ((k, v, bias, H), {"out": (codes, scales, codes.float(),
                                       scales)}),
            ((k, v, bias, H), {"out": (codes.transpose(-1, -2), scales,
                                       codes, scales)})):
        with pytest.raises(ValueError):
            xa.cross_kv_quant(*args, **kw)
    assert xa.cross_kv_quant.launches == n
    stream = torch.cuda.current_stream().cuda_stream
    with pytest.raises(RuntimeError):
        library().call("wtt_cross_kv_quant", odd.data_ptr(), v.data_ptr(),
                       bias.data_ptr(), codes.data_ptr(), scales.data_ptr(),
                       codes.data_ptr(), scales.data_ptr(), B, H, Ta, stream)
    with pytest.raises(RuntimeError):
        library().call("wtt_cross_kv_quant", k.data_ptr(), v.data_ptr(),
                       bias.data_ptr(), codes.data_ptr(), scales.data_ptr(),
                       codes.data_ptr(), scales.data_ptr(), 0, H, Ta, stream)


def _omni_small():
    """Uni-MoE-2.0-Omni's language model at a small width: d 256, 8 query
    and 2 KV heads of 32 channels, 2 layers, 4 routed + 2 shared + 1 null
    experts, vocabulary 1024; the encoder at width 128 (K1's 64-channel
    heads)."""
    from whisper_tpu_torch.models import uni_moe_omni as omni
    cfg = omni.OmniConfig(
        n_vocab=1024, d_model=256, n_layer=2, n_head=8, n_kv_head=2,
        head_dim=32, routed_ffn=384, shared_ffn=96, n_audio_tokens=20,
        audio_state=128, prompt_head=(1, 2, 3), prompt_tail=(4, 5),
        eos=1024)
    enc = wm.WhisperConfig(512, 1500, 128, 2, 2, 448, 128, 2, 2, 128)
    return omni, cfg, enc


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_uni_moe_omni_prefill_and_step_on_card(gen, dtype):
    """The audio-LLM's prefill and greedy steps through the cache on the
    card against the same code on the CPU in float32: bit-near in float32
    (TF32 off; summation order only), within bf16 rounding in bf16, where
    the CPU run is handed nothing (both route by their own probabilities,
    and a routing flip at this width moves the logits past the bound only
    within ~1e-2 of a boundary, which the planted seed avoids)."""
    from whisper_tpu_torch.weights.convert import param_shapes
    omni, cfg, enc = _omni_small()
    cpu = omni.random_params(param_shapes(enc)["encoder"], cfg, seed=4,
                             dtype=torch.float32, scale=0.05)

    def to(tree):
        return {k: to(v) if isinstance(v, dict) else
                v.to("cuda", dtype if v.dtype == torch.float32 and
                     k in omni.WEIGHT_KEYS else v.dtype)
                for k, v in tree.items()}
    card = to(cpu)
    audio = torch.randn(3, 20, 256, generator=torch.Generator().manual_seed(1))
    outs = []
    for params, dev, dt in ((cpu, "cpu", torch.float32),
                            (card, "cuda", dtype)):
        routes = []
        cache = omni.new_cache(cfg, 3, cfg.prompt_len + 8, dev, dt)
        with torch.no_grad():
            ids, lps = omni.greedy(params, cfg, audio.to(dev), cache, 8,
                                   routes)
        outs.append((ids, lps, [k.cpu() for k, _ in routes]))
    (ids0, lp0, k0), (ids1, lp1, k1) = outs
    flips = sum(int((a != b).any(-1).sum()) for a, b in zip(k0, k1))
    if dtype == torch.float32:
        assert torch.equal(ids0, ids1) and flips == 0
        assert float((lp0 - lp1).abs().max()) < 1e-4
    else:
        # the first token's log-probability is the best one's on both
        # sides, whichever token that is
        assert flips <= 0.01 * sum(len(k) for k in k0)
        assert float((lp0[:, 0] - lp1[:, 0]).abs().max()) < 5e-2


def test_uni_moe_omni_step_graphs_give_the_eager_bits(gen):
    """The one-token step as CUDA graphs (`_StepGraphs`) against the same
    step run op by op on one card, bf16: the same tokens,
    log-probabilities, kept sets and router probabilities bit for bit,
    over two rounds on one cache (the graphs built once, at its first
    step)."""
    from whisper_tpu_torch.weights.convert import param_shapes
    omni, cfg, enc = _omni_small()
    params = omni.random_params(param_shapes(enc)["encoder"], cfg, seed=6,
                                dtype=torch.bfloat16, device="cuda",
                                scale=0.05)
    audio = torch.randn(2, 4, 20, 256, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(2))
    runs = {}
    for graphs in (False, True):
        cache = omni.new_cache(cfg, 4, cfg.prompt_len + 8, "cuda")
        if not graphs:
            cache["graphs"] = False         # the steps op by op
        for rnd in range(2):
            routes = []
            with torch.no_grad():
                ids, lps = omni.greedy(params, cfg, audio[rnd], cache, 8,
                                       routes)
            runs[graphs, rnd] = (ids, lps, [k.cpu() for k, _ in routes],
                                 [p.cpu() for _, p in routes])
        built = cache["graphs"]
        assert isinstance(built, omni._StepGraphs) == graphs
    for rnd in range(2):
        eager, graphed = runs[False, rnd], runs[True, rnd]
        assert torch.equal(eager[0], graphed[0])
        assert torch.equal(eager[1], graphed[1])
        assert len(eager[2]) == len(graphed[2]) == cfg.n_layer * 8
        assert all(torch.equal(a, b) for a, b in zip(eager[2], graphed[2]))
        assert all(torch.equal(a, b) for a, b in zip(eager[3], graphed[3]))


def test_uni_moe_omni_transcribe_on_card(gen):
    """BatchTranscriber on an AudioLLMContext on the card, bf16, with the
    tracer on: one segment a window of max_tokens tokens, the `moe` spans'
    device time read, and the counters' sums consistent."""
    from whisper_tpu_torch.api import AudioLLMContext
    from whisper_tpu_torch.weights.convert import param_shapes
    omni, cfg, enc = _omni_small()
    params = omni.random_params(param_shapes(enc)["encoder"], cfg, seed=5,
                                dtype=torch.bfloat16, device="cuda",
                                scale=0.05)
    ctx = AudioLLMContext(enc, cfg, params, device="cuda")
    p = full_default_params()
    p.no_timestamps, p.temperature_inc, p.max_tokens = True, 0.0, 6
    p.print_progress = False
    bt = BatchTranscriber(ctx, batch_size=4, params=p, device_mel=True)
    bt.warmup(pcm_dtype=np.int16)
    rng = np.random.default_rng(0)
    streams = [(rng.standard_normal(16000 * 45) * 3000).astype(np.int16)
               for _ in range(4)]
    TRACE.drain()
    TRACE.enable()
    try:
        out = bt.transcribe(streams)
    finally:
        TRACE.disable()
    s = TRACE.summary()
    TRACE.drain()
    assert [len(segs) for segs in out] == [2] * 4
    assert all(len(seg.tokens) == 6 for segs in out for seg in segs)
    assert s["llm_prefill"]["count"] == 2 and s["llm_step"]["count"] == 10
    assert s["moe"]["count"] == 2 * 12 and s["moe"]["stream_seconds"] > 0
    assert s["moe_tokens"]["value"] == 2 * 2 * 4 * (cfg.prompt_len + 5)
    assert s["moe_tokens"]["value"] <= s["moe_routed"]["value"] + \
        s["moe_null"]["value"] <= 2 * s["moe_tokens"]["value"]
