"""Plain Whisper forward pass: the benchmark's reference.

Written from the published model (OpenAI's Whisper: a conv stem, a
pre-LN transformer encoder and decoder, cross-attention on the encoder
output, logits tied to the token embedding) and from whisper.cpp's
decoding rules, in plain PyTorch.  It imports nothing of the program.
Departures from OpenAI's PyTorch model, each the rule of the system
under test (whisper.cpp's): GELU is the tanh approximation (ggml_gelu),
and the log-mel pads and frames the signal as whisper.cpp does.

`precision` chooses the arithmetic of every product:

  "f32"  float32 throughout, TF32 off (the reference);
  "fp8"  each operand of every matrix product and convolution rounded to
         float8 e4m3, with a scale a row (a weight's output channel, an
         activation's token), and the cross-attention K/V rounded to int4
         with a scale a key and head: the nearest precision below the
         configuration's bfloat16 compute and int8 cross-KV (the control).

Weights are the benchmark's params dict, in the layout it hands the
program (stacked (L, out, in) linears, nested "encoder" / "decoder").
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16000
N_FFT = 400
HOP = 160
CHUNK_S = 30
WINDOW_FRAMES = 2 * 1500        # mel frames of one 30 s window
FP8_MAX = 448.0                 # largest finite float8 e4m3
INT4_MAX = 7.0


def no_tf32() -> None:
    """float32 products in float32: the reference is float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# tokens (whisper.cpp's vocabulary layout)
# ---------------------------------------------------------------------------

def special_tokens(n_vocab: int) -> dict:
    """whisper.cpp's special ids: GPT-2's, moved by one for the
    multilingual eot/sot, and the task tokens by num_languages - 98."""
    multilingual = n_vocab >= 51865
    n_lang = n_vocab - 51765 - (1 if multilingual else 0)
    shift = 1 if multilingual else 0
    dt = n_lang - 98 if multilingual else 0
    tok = {"eot": 50256 + shift, "sot": 50257 + shift,
           "translate": 50357 + dt, "transcribe": 50358 + dt,
           "solm": 50359 + dt, "prev": 50360 + dt, "nosp": 50361 + dt,
           "not": 50362 + dt, "beg": 50363 + dt, "n_lang": n_lang,
           "space": 220}   # " " in the GPT-2 vocabulary
    return tok


def language_id(code: str) -> int:
    """Whisper's language order starts en, zh, de, ...: only "en" is
    needed by the cells."""
    order = ("en", "zh", "de", "es", "ru", "ko", "fr", "ja", "pt", "tr")
    return order.index(code)


def initial_prompt(tok: dict, language: str, no_timestamps: bool) -> list:
    """[sot, language, transcribe(, notimestamps)]."""
    prompt = [tok["sot"], tok["sot"] + 1 + language_id(language),
              tok["transcribe"]]
    if no_timestamps:
        prompt.append(tok["not"])
    return prompt


def suppressed(tok: dict, n_vocab: int, no_timestamps: bool,
               initial: bool) -> torch.Tensor:
    """(V,) bool: the tokens greedy decoding may not take (whisper.cpp's
    whisper_process_logits without a grammar, tinydiarize or the
    non-speech list): notimestamps, sot, nosp, solm, the task tokens,
    prev, every language, every timestamp when they are off, and at the
    first sampled token the blank ones (eot and " ")."""
    mask = torch.zeros(n_vocab, dtype=torch.bool)
    for name in ("not", "sot", "nosp", "solm", "translate", "transcribe",
                 "prev"):
        mask[tok[name]] = True
    mask[tok["sot"] + 1: tok["sot"] + 1 + tok["n_lang"]] = True
    if no_timestamps:
        mask[tok["beg"]:] = True
    if initial:
        mask[tok["eot"]] = True
        mask[tok["space"]] = True
    return mask


# ---------------------------------------------------------------------------
# log-mel
# ---------------------------------------------------------------------------

def mel_filterbank(n_mels: int) -> np.ndarray:
    """librosa.filters.mel(sr=16000, n_fft=400, n_mels, htk=False,
    norm="slaney"): triangles on the Slaney mel scale, area-normalised."""
    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        lin = f / (200.0 / 3)
        log = 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27)
        return np.where(f >= 1000.0, log, lin)

    def mel_to_hz(m):
        m = np.asarray(m, np.float64)
        lin = m * (200.0 / 3)
        log = 1000.0 * np.exp((np.log(6.4) / 27) * (m - 15.0))
        return np.where(m >= 15.0, log, lin)

    freqs = np.linspace(0, SAMPLE_RATE / 2, N_FFT // 2 + 1)
    pts = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(SAMPLE_RATE / 2),
                                n_mels + 2))
    weights = np.zeros((n_mels, len(freqs)))
    for m in range(n_mels):
        lo, mid, hi = pts[m], pts[m + 1], pts[m + 2]
        up = (freqs - lo) / (mid - lo)
        down = (hi - freqs) / (hi - mid)
        weights[m] = np.maximum(0.0, np.minimum(up, down)) * 2.0 / (hi - lo)
    return weights


def pad_signal(pcm: np.ndarray) -> tuple[np.ndarray, int]:
    """whisper.cpp's padding: 200 samples reflected at the head, then the
    signal, then 30 s and 200 samples of zeros.  -> (float64 padded
    signal, frames that cover the signal: the stream's seek_end)."""
    x = np.asarray(pcm)
    x = x.astype(np.float64) / 32768.0 if x.dtype == np.int16 else \
        x.astype(np.float64)
    half = N_FFT // 2
    if len(x) < 1 + half:
        x = np.pad(x, (0, 1 + half - len(x)))
    out = np.zeros(len(x) + SAMPLE_RATE * CHUNK_S + 2 * half)
    out[half:half + len(x)] = x
    out[:half] = x[1:1 + half][::-1]
    return out, 1 + (len(x) + half - N_FFT) // HOP


def log_mel(signal: torch.Tensor, filters: torch.Tensor) -> torch.Tensor:
    """float64 (S,) padded signal -> (n_frames, n_mels): power spectrum of
    periodic-Hann frames, mel, log10 floored at 1e-10, clamped to 8 below
    the block's maximum, then (x + 4) / 4."""
    n = (signal.shape[-1] - N_FFT) // HOP
    hann = 0.5 * (1 - torch.cos(2 * math.pi * torch.arange(
        N_FFT, dtype=torch.float64, device=signal.device) / N_FFT))
    frames = signal.unfold(-1, N_FFT, HOP)[:n] * hann
    power = torch.fft.rfft(frames, dim=-1).abs() ** 2
    mel = torch.log10(torch.clamp_min(power @ filters.T, 1e-10))
    mel = torch.maximum(mel, mel.max() - 8.0)
    return (mel + 4.0) / 4.0


def window_mel(pcm: np.ndarray, seek: int, per_window: bool, n_mels: int,
               device) -> torch.Tensor:
    """(3000, n_mels) float32 log-mel of the 30 s window at frame `seek`.
    per_window: the mel of the window's own samples, normalised over the
    window (the device mel); else the mel of the whole padded stream,
    normalised over the stream, and the window's frames cut from it (the
    host mel)."""
    padded, _ = pad_signal(pcm)
    filters = torch.from_numpy(mel_filterbank(n_mels)).to(device)
    if per_window:
        n = WINDOW_FRAMES * HOP + N_FFT
        cut = np.zeros(n)
        part = padded[seek * HOP: seek * HOP + n]
        cut[:len(part)] = part
        mel = log_mel(torch.from_numpy(cut).to(device), filters)
        return mel[:WINDOW_FRAMES].float()
    mel = log_mel(torch.from_numpy(padded).to(device), filters)
    out = torch.zeros((WINDOW_FRAMES, n_mels), dtype=torch.float64,
                      device=device)
    part = mel[seek:seek + WINDOW_FRAMES]
    out[:len(part)] = part
    return out.float()


# ---------------------------------------------------------------------------
# arithmetic of a precision
# ---------------------------------------------------------------------------

def _fp8_rows(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with a scale per row (last axis)."""
    scale = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _int4_keys(kv: torch.Tensor, head_dim: int) -> torch.Tensor:
    """(Ta, D) K or V rounded to int4, a scale a key and head."""
    ta, d = kv.shape
    h = kv.reshape(ta, d // head_dim, head_dim)
    scale = h.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30) / INT4_MAX
    return (torch.round(h / scale).clamp(-INT4_MAX, INT4_MAX)
            * scale).reshape(ta, d)


class Arith:
    """Products in the chosen precision (see the module docstring)."""

    def __init__(self, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.fp8 = precision == "fp8"

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return _fp8_rows(x) if self.fp8 else x

    def linear(self, x, w, b=None):
        y = self.q(x.float()) @ self.q(w.float()).T
        return y if b is None else y + b.float()

    def conv(self, x, w, b, stride):
        """conv1d(k=3, padding=1) of (C_in, T) -> (C_out, T')."""
        if self.fp8:
            x = _fp8_rows(x.T).T              # a scale a time step
            w = _fp8_rows(w.reshape(w.shape[0], -1)).reshape(w.shape)
        y = F.conv1d(x[None], w.float(), stride=stride, padding=1)[0]
        return y + b.float()[:, None]

    def kv(self, x, head_dim):
        return _int4_keys(x, head_dim) if self.fp8 else x


def _ln(x, w, b):
    return F.layer_norm(x, (x.shape[-1],), w.float(), b.float(), 1e-5)


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _attend(ar: Arith, q, k, v, n_head, causal=False):
    """Multi-head attention of (Tq, D) q on (Tk, D) k, v."""
    tq, d = q.shape
    dh = d // n_head
    qh = q.reshape(tq, n_head, dh).transpose(0, 1)
    kh = k.reshape(-1, n_head, dh).transpose(0, 1)
    vh = v.reshape(-1, n_head, dh).transpose(0, 1)
    s = (ar.q(qh) @ ar.q(kh).transpose(1, 2)) * dh ** -0.5
    if causal:
        s = s + torch.full((tq, tq), float("-inf"), device=q.device).triu(1)
    p = torch.softmax(s, dim=-1)
    o = ar.q(p) @ ar.q(vh.transpose(1, 2)).transpose(1, 2)
    return o.transpose(0, 1).reshape(tq, d)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def encode(params, mel: torch.Tensor, n_head: int, ar: Arith):
    """(3000, n_mels) log-mel -> (1500, D) encoder output."""
    enc = params["encoder"]
    x = _gelu(ar.conv(mel.T, enc["conv1_w"], enc["conv1_b"], 1))
    x = _gelu(ar.conv(x, enc["conv2_w"], enc["conv2_b"], 2)).T
    x = x + enc["pos"][:x.shape[0]].float()
    blocks = enc["blocks"]
    for l in range(blocks["q_w"].shape[0]):
        blk = {key: w[l] for key, w in blocks.items()}
        h = _ln(x, blk["attn_ln_w"], blk["attn_ln_b"])
        a = _attend(ar, ar.linear(h, blk["q_w"], blk["q_b"]),
                    ar.linear(h, blk["k_w"]), ar.linear(h, blk["v_w"],
                                                        blk["v_b"]), n_head)
        x = x + ar.linear(a, blk["o_w"], blk["o_b"])
        h = _ln(x, blk["mlp_ln_w"], blk["mlp_ln_b"])
        x = x + ar.linear(_gelu(ar.linear(h, blk["mlp0_w"], blk["mlp0_b"])),
                          blk["mlp2_w"], blk["mlp2_b"])
    return _ln(x, enc["ln_post_w"], enc["ln_post_b"])


def cross_kv(params, enc_out, n_head: int, ar: Arith):
    """Each decoder layer's cross-attention K and V of the encoder output."""
    blocks = params["decoder"]["blocks"]
    dh = enc_out.shape[-1] // n_head
    return [(ar.kv(ar.linear(enc_out, blocks["xk_w"][l]), dh),
             ar.kv(ar.linear(enc_out, blocks["xv_w"][l], blocks["xv_b"][l]),
                   dh))
            for l in range(blocks["xk_w"].shape[0])]


def decode(params, tokens: list, kv_cross, n_head: int, ar: Arith):
    """Teacher-forced decoder over `tokens` -> (T, V) float32 logits, row
    t predicting the token after tokens[t]."""
    dec = params["decoder"]
    dev = dec["tok_emb"].device
    ids = torch.as_tensor(tokens, dtype=torch.long, device=dev)
    x = dec["tok_emb"][ids].float() + dec["pos"][:len(tokens)].float()
    blocks = dec["blocks"]
    for l, (kc, vc) in enumerate(kv_cross):
        blk = {key: w[l] for key, w in blocks.items()}
        h = _ln(x, blk["attn_ln_w"], blk["attn_ln_b"])
        a = _attend(ar, ar.linear(h, blk["q_w"], blk["q_b"]),
                    ar.linear(h, blk["k_w"]),
                    ar.linear(h, blk["v_w"], blk["v_b"]), n_head, causal=True)
        x = x + ar.linear(a, blk["o_w"], blk["o_b"])
        h = _ln(x, blk["xattn_ln_w"], blk["xattn_ln_b"])
        a = _attend(ar, ar.linear(h, blk["xq_w"], blk["xq_b"]), kc, vc,
                    n_head)
        x = x + ar.linear(a, blk["xo_w"], blk["xo_b"])
        h = _ln(x, blk["mlp_ln_w"], blk["mlp_ln_b"])
        x = x + ar.linear(_gelu(ar.linear(h, blk["mlp0_w"], blk["mlp0_b"])),
                          blk["mlp2_w"], blk["mlp2_b"])
    x = _ln(x, dec["ln_w"], dec["ln_b"])
    return ar.linear(x, dec["tok_emb"])
