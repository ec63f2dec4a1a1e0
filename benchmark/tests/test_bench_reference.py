"""The reference against the port's own float32 path at micro dims on the
CPU: the two log-mels, the encoder, the cross K/V and a teacher-forced
decoder pass agree to float32 rounding.  (The benchmark's comparison runs
the reference against the port's bf16 path on the card.)"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from benchmark import model, traffic
from benchmark.reference import check
from benchmark.reference import whisper as ref
from benchmark.tests.conftest import HERE, MICRO


@pytest.fixture(scope="module")
def micro_f32():
    cfg = json.loads((HERE / "configs" / "large-v3.json").read_text())
    cfg.update(MICRO, compute_dtype="float32", name="micro")
    return cfg, model.make_params(cfg, 11, "cpu")


def _pcm(n=16000 * 12):
    spec = json.loads((HERE / "traffic" / "clips-8s-4.8rps.json").read_text())
    return traffic.clip_pcm(spec, 3, 0, n)


@pytest.mark.parametrize("seek", [0, 400])
def test_host_mel_is_the_ports(seek, monkeypatch):
    from whisper_tpu_torch.audio.filters import mel_filterbank
    from whisper_tpu_torch.audio.mel import log_mel_spectrogram
    monkeypatch.setenv("WTPU_NO_NATIVE", "1")
    pcm = _pcm()
    port, _ = log_mel_spectrogram(pcm, mel_filterbank(128))
    mine = ref.window_mel(pcm, seek, False, 128, "cpu").numpy()
    want = np.zeros_like(mine)
    part = port[seek:seek + 3000]
    want[:len(part)] = part
    assert np.abs(mine - want).max() < 2e-4


@pytest.mark.parametrize("seek", [0, 700])
def test_device_mel_is_the_ports(seek):
    from whisper_tpu_torch.audio.filters import mel_filterbank
    from whisper_tpu_torch.audio.mel import (log_mel_spectrogram_torch,
                                             pad_audio)
    pcm = _pcm()
    padded, _, _ = pad_audio(pcm)
    win = np.zeros(3000 * 160 + 400, np.float32)
    part = padded[seek * 160: seek * 160 + len(win)].astype(np.float32)
    win[:len(part)] = part / 32768.0
    port = log_mel_spectrogram_torch(torch.from_numpy(win)[None],
                                     torch.from_numpy(mel_filterbank(128)))
    mine = ref.window_mel(pcm, seek, True, 128, "cpu")
    assert float((mine - port[0, :3000]).abs().max()) < 2e-4


def test_model_is_the_ports_float32(micro_f32):
    from whisper_tpu_torch.models import whisper as wm
    cfg, params = micro_f32
    mel = ref.window_mel(_pcm(), 0, True, 128, "cpu")
    ar = ref.Arith("f32")
    enc = ref.encode(params, mel, 2, ar)
    with torch.no_grad():
        penc = wm.encode(params, mel[None], n_head=2,
                         compute_dtype=torch.float32, attn_impl="einsum")[0]
    assert float((enc - penc).abs().max()) < 1e-4 * float(penc.abs().max())
    kv = ref.cross_kv(params, enc, 2, ar)
    with torch.no_grad():
        kc, vc = wm.cross_kv(params, penc[None], n_head=2,
                             compute_dtype=torch.float32)
    # the port's (L, B, H, Dh, Ta) against the reference's (Ta, D)
    pk = kc[:, 0].permute(0, 3, 1, 2).reshape(2, 1500, 128)
    pv = vc[:, 0].permute(0, 3, 1, 2).reshape(2, 1500, 128)
    for l in range(2):
        assert torch.allclose(kv[l][0], pk[l], atol=1e-4, rtol=1e-4)
        assert torch.allclose(kv[l][1], pv[l], atol=1e-4, rtol=1e-4)
    tokens = [50258, 50259, 50360, 50364, 11, 2000, 31000]
    logits = ref.decode(params, tokens, kv, 2, ar)
    t = torch.tensor([tokens])
    with torch.no_grad():
        plog, _, _ = wm.decode_prompt(
            params, t, torch.arange(len(tokens)), kc, vc, n_head=2,
            self_mask=wm.make_causal_mask(len(tokens)),
            compute_dtype=torch.float32)
    assert float((logits - plog[0]).abs().max()) < 1e-3


def test_carried_prompts_follow_whisper_cpp():
    tok = ref.special_tokens(51866)
    init = ref.initial_prompt(tok, "en", True)
    served = [[1, 2, 3], [4, 5], [6]]
    # n_max_text_ctx 4: the last four tokens of the past are carried
    got = check.carried_prompts(init, served, tok, 4, 448, [0, 3000, 6000],
                                8999)
    assert got[0] == init
    assert got[1] == [tok["prev"], 1, 2, 3] + init
    assert got[2] == [tok["prev"], 2, 3, 4, 5] + init
    # a window within 5 s of the end drops the past
    got = check.carried_prompts(init, served, tok, 64, 448, [0, 3000, 6000],
                                6400)
    assert got[2] == init
