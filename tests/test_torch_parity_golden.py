"""The golden file of the port's segment parity on the card
(tests/port_parity.py): it still equals whisper_tpu's run on the CPU, its
held counts come out again (beam 5's from whisper_tpu's own perturbed
runs), the port in f32 on the CPU emits every golden token and gives its
teacher-forced gaps, and the comparisons the card makes hold and refuse
what they should.

    JAX_PLATFORMS=cpu PYTHONPATH=.:tests python \
        tests/test_torch_parity_golden.py --write     # rewrite the file
    ... tests/test_torch_parity_golden.py --search FIRST COUNT
                      # held counts of PCM seeds FIRST.., to choose streams
"""

import hashlib
import json
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import port_parity as pp  # noqa: E402


def _sha256(path) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _teacher_forced(jctx, bt, pcm, tokens):
    """Each emitted token's log-prob gap under whisper_tpu's decoder and
    filter chain: the distance from its filtered log-prob to the nearest
    other token's at its step, from one decode_prompt over the prompt and
    the tokens before it (no timestamps: the chain's state is the
    first-step flags, then none)."""
    from whisper_tpu.audio.mel import pad_audio
    from whisper_tpu.constants import HOP_LENGTH, N_FFT
    from whisper_tpu.decode.filters import FilterConsts, make_process_logits
    from whisper_tpu.models import whisper as wm
    n_ctx = jctx.hparams.n_audio_ctx
    S = 2 * n_ctx * HOP_LENGTH + N_FFT
    padded = pad_audio(np.asarray(pcm))[0][:S]
    (kq, ks), (vq, vs) = bt._encode_batch(padded[None])
    prompt = list(bt.prompt_init)
    seq = np.asarray([prompt + tokens[:-1]], np.int32)
    T = seq.shape[1]
    logits, _, _ = wm.decode_prompt(
        jctx.params, jnp.asarray(seq), jnp.arange(T), ("q8", kq, ks),
        ("q8", vq, vs), jctx.config.n_text_head,
        self_mask=wm.make_causal_mask(T), compute_dtype=jnp.float32)
    process = make_process_logits(
        FilterConsts.from_vocab(jctx.vocab, n_ctx), bt.opts)
    gaps = []
    for j, tok in enumerate(tokens):
        f = jnp.zeros((1,), bool)
        _, lp, _ = process(logits[:, len(prompt) - 1 + j], 0.0,
                           is_initial=jnp.full((1,), j == 0),
                           last_was_ts=f, penult_was_ts=~f, has_ts=f,
                           seek_delta=jnp.zeros((1,), jnp.int32))
        lp = np.asarray(lp[0], np.float64)
        others = np.delete(lp, tok)
        gaps.append(float(np.abs(lp[tok] - others[np.isfinite(others)])
                          .min()))
    return gaps


def _jax_context(path):
    from whisper_tpu.api import WhisperContext as JaxContext
    return JaxContext.from_file(path, compute_dtype=jnp.float32,
                                cross_mode=pp.CROSS_MODE)


def _jax_batch(jctx, config):
    from whisper_tpu.api import full_default_params as jax_params
    from whisper_tpu.parallel.batch import BatchTranscriber as JaxBatch
    return JaxBatch(jctx, batch_size=pp.BATCH,
                    params=pp.params(jax_params, config), device_mel=True)


def jax_streams(jctx, config, pcms) -> list[dict]:
    """whisper_tpu's BatchTranscriber on the CPU (f32) over `pcms` in
    `config`: each stream's segments, tokens, log-probs and gaps."""
    bt = _jax_batch(jctx, config)
    rows = []
    for pcm, segs in zip(pcms, bt.transcribe(pcms)):
        toks = [t for s in segs for t in s.tokens]
        ids = [t.id for t in toks]
        rows.append({
            "segments": [[s.t0, s.t1, s.text] for s in segs],
            "tokens": ids, "plogs": [t.plog for t in toks],
            "gaps": _teacher_forced(jctx, bt, pcm, ids)})
    return rows


def jax_golden(tmp_dir) -> dict:
    """whisper_tpu's runs over the parity file and streams, each config."""
    path = pp.write_model(tmp_dir / "parity.bin")
    jctx = _jax_context(path)
    out = {"dims": list(pp.DIMS), "kind": pp.KIND,
           "model_seed": pp.MODEL_SEED, "model_sha256": _sha256(path),
           "pcm_seeds": {c: list(v) for c, v in pp.PCM_SEEDS.items()},
           "pcm_seconds": pp.PCM_SECONDS,
           "cross_mode": pp.CROSS_MODE, "batch": pp.BATCH,
           "max_tokens": pp.MAX_TOKENS}
    for config in pp.CONFIGS:
        out[config] = {"streams": jax_streams(jctx, config,
                                                pp.streams(config))}
    return out


def beam_held(path, pcms, golden_streams) -> list[int]:
    """Each stream's golden beam tokens that whisper_tpu's f32 beam 5 keeps
    in every one of BEAM_TRIALS runs with its filtered log-probs perturbed
    by uniform noise of +-BF16_NOISE at every step (drawn on the host from
    a seeded generator through io_callback, so the window compiles once).
    The reference alone decides how far the port is compared."""
    from jax.experimental import io_callback
    from whisper_tpu.decode import beam as jbeam
    orig = jbeam.make_process_logits
    gen = np.random.default_rng(0)

    def noise(shape):
        return ((gen.random(shape) * 2 - 1) * pp.BF16_NOISE).astype(
            np.float32)

    def noisy(*args, **kw):
        process = orig(*args, **kw)

        def run(*a, **k):
            lg, lp, _ = process(*a, **k)
            lp = lp + io_callback(lambda: noise(lp.shape),
                                  jax.ShapeDtypeStruct(lp.shape, jnp.float32))
            return lg, lp, jnp.exp(lp)
        return run

    held = [len(s["tokens"]) for s in golden_streams]
    jbeam.make_process_logits = noisy
    try:
        # a context of its own: its window is built with the noise
        bt = _jax_batch(_jax_context(path), "beam5")
        for _ in range(pp.BEAM_TRIALS):
            for si, segs in enumerate(bt.transcribe(pcms)):
                got = pp.stream_tokens(segs)
                want = golden_streams[si]["tokens"]
                same = next((i for i, (a, b) in enumerate(zip(got, want))
                             if a != b), min(len(got), len(want)))
                held[si] = min(held[si], same)
    finally:
        jbeam.make_process_logits = orig
    return held


def write_golden(tmp_dir) -> dict:
    data = jax_golden(tmp_dir)
    for s in data["greedy"]["streams"]:
        s["held"] = pp.greedy_held(s["gaps"])
    held = beam_held(str(tmp_dir / "parity.bin"), pp.streams("beam5"),
                     data["beam5"]["streams"])
    for s, n in zip(data["beam5"]["streams"], held):
        s["held"] = n
    return data


def search(tmp_dir, first: int, count: int) -> None:
    """Print, for the PCM seeds first..first+count-1, each stream's greedy
    held count and decided steps, and its beam 5 held count: the parity
    streams are chosen from them (port_parity.PCM_SEEDS)."""
    path = pp.write_model(tmp_dir / "parity.bin")
    jctx = _jax_context(path)
    seeds = list(range(first, first + count))
    pcms = [pp.stream(s) for s in seeds]
    rows = jax_streams(jctx, "greedy", pcms)
    print("greedy held", dict(zip(seeds, (pp.greedy_held(r["gaps"])
                                          for r in rows))))
    print("greedy decided", dict(zip(seeds, (len(pp.decided(r["gaps"]))
                                             for r in rows))), flush=True)
    print("beam5 held", dict(zip(seeds, beam_held(
        path, pcms, jax_streams(jctx, "beam5", pcms)))))


@pytest.fixture(scope="module")
def golden():
    return pp.load_golden()


def test_golden_file_still_equals_jax(tmp_path, golden):
    want = jax_golden(tmp_path)
    for key in ("dims", "kind", "model_seed", "model_sha256", "pcm_seeds",
                "max_tokens"):
        assert golden[key] == want[key], key
    for config in pp.CONFIGS:
        for a, b in zip(golden[config]["streams"], want[config]["streams"]):
            assert a["tokens"] == b["tokens"]
            assert a["segments"] == b["segments"]
            np.testing.assert_allclose(a["plogs"], b["plogs"], rtol=1e-5,
                                       atol=1e-6)
            np.testing.assert_allclose(a["gaps"], b["gaps"], rtol=1e-4,
                                       atol=1e-6)


def test_held_counts_come_out_again(tmp_path, golden):
    """Greedy's from the golden gaps; beam 5's from whisper_tpu's perturbed
    runs; every greedy stream has MIN_PREFIX decided steps, and beam 5's
    streams hold MIN_PREFIX tokens in all."""
    for s in golden["greedy"]["streams"]:
        assert s["held"] == pp.greedy_held(s["gaps"])
        assert len(pp.decided(s["gaps"])) >= pp.MIN_PREFIX
    path = pp.write_model(tmp_path / "parity.bin")
    streams = golden["beam5"]["streams"]
    assert beam_held(path, pp.streams("beam5"), streams) == [s["held"]
                                                      for s in streams]
    assert sum(s["held"] for s in streams) >= pp.MIN_PREFIX


def _f32_context(path):
    from whisper_tpu_torch import WhisperContext
    return WhisperContext.from_file(path, compute_dtype=torch.float32,
                                    device="cpu", keep_quantized=False,
                                    cross_mode=pp.CROSS_MODE)


def _batch(ctx, config):
    from whisper_tpu_torch import BatchTranscriber, full_default_params
    return BatchTranscriber(ctx, batch_size=pp.BATCH,
                            params=pp.params(full_default_params, config),
                            device_mel=True)


@pytest.mark.parametrize("config", pp.CONFIGS)
def test_port_f32_emits_every_golden_token(tmp_path, golden, config):
    """The port in f32 on the CPU (the file densified, as whisper_tpu's CPU
    context does) emits all of it, and the comparison the card makes
    passes over every token."""
    path = pp.write_model(tmp_path / "parity.bin")
    assert _sha256(path) == golden["model_sha256"]
    res = _batch(_f32_context(path), config).transcribe(pp.streams(config))
    for segs, ref in zip(res, golden[config]["streams"]):
        assert pp.stream_tokens(segs) == ref["tokens"]
    held = pp.compare(config, res, golden)
    assert held["agree"] == [len(s["tokens"])
                             for s in golden[config]["streams"]]
    assert held["max_plog_diff"] < 1e-3     # f32 against f32


def test_port_f32_teacher_forced_gaps_are_the_golden_ones(tmp_path, golden):
    """The teacher-forced pass the card makes (port_parity
    .teacher_forced_gaps), run by the port in f32 on the CPU, gives the
    golden gaps, and check_decided passes on them."""
    ctx = _f32_context(pp.write_model(tmp_path / "parity.bin"))
    bt = _batch(ctx, "greedy")
    streams = golden["greedy"]["streams"]
    gaps = [pp.teacher_forced_gaps(ctx, bt, pcm, s["tokens"])
            for pcm, s in zip(pp.streams("greedy"), streams)]
    # f32 against f32: one decode_prompt over the window's tokens in torch
    # against XLA's read gaps within 2.1e-3 of each other
    for got, s in zip(gaps, streams):
        np.testing.assert_allclose(got, s["gaps"], rtol=0, atol=5e-3)
    out = pp.check_decided(gaps, golden)
    assert out["decided"] == [len(pp.decided(s["gaps"])) for s in streams]
    assert out["max_gap_change"] < 5e-3


def test_compare_holds_the_prefix_only(golden):
    """A token changed within a stream's held prefix fails; one changed
    past it passes; beam 5's streams holding under MIN_PREFIX in all
    fail."""
    from types import SimpleNamespace as NS

    def segs(ids, plogs):
        return [NS(tokens=[NS(id=i, plog=p) for i, p in zip(ids, plogs)])]

    for config in pp.CONFIGS:
        streams = golden[config]["streams"]
        exact = [segs(s["tokens"], s["plogs"]) for s in streams]
        held = pp.compare(config, exact, golden)
        assert held["max_plog_diff"] == 0
        assert held["covered"] == sum(s["held"] for s in streams)
        for si, s in enumerate(streams):
            n = s["held"]
            broken = list(exact)
            if n > 0:
                bad = list(s["tokens"])
                bad[n - 1] += 1
                broken[si] = segs(bad, s["plogs"])
                with pytest.raises(AssertionError, match=f"stream {si}"):
                    pp.compare(config, broken, golden)
            if n < len(s["tokens"]):
                late = list(s["tokens"])
                late[n] += 1
                broken[si] = segs(late, s["plogs"])
                pp.compare(config, broken, golden)
    streams = golden["beam5"]["streams"]
    short = [dict(s, held=0) for s in streams]
    short[0]["held"] = pp.MIN_PREFIX - 1
    with pytest.raises(AssertionError, match="tokens held"):
        pp.compare("beam5", [segs(s["tokens"], s["plogs"])
                             for s in streams], {"beam5": {"streams": short}})


def test_check_decided_refuses_what_it_should(golden):
    """A decided step whose golden token does not lead fails; an undecided
    one may; a stream with fewer than MIN_PREFIX decided steps fails."""
    streams = golden["greedy"]["streams"]
    exact = [np.asarray(s["gaps"]) for s in streams]
    pp.check_decided(exact, golden)
    for si, s in enumerate(streams):
        steps = pp.decided(s["gaps"])
        flipped = [g.copy() for g in exact]
        flipped[si][steps[-1]] = -0.01
        with pytest.raises(AssertionError, match=f"stream {si}: step"):
            pp.check_decided(flipped, golden)
        loose = [j for j in range(len(s["gaps"])) if j not in steps]
        if loose:
            flipped = [g.copy() for g in exact]
            flipped[si][loose[0]] = -0.01
            pp.check_decided(flipped, golden)
    few = [dict(s, gaps=[0.0] * len(s["gaps"])) for s in streams]
    with pytest.raises(AssertionError, match="decided steps"):
        pp.check_decided(exact, {"greedy": {"streams": few}})


if __name__ == "__main__":
    if "--write" not in sys.argv and "--search" not in sys.argv:
        sys.exit(__doc__)
    import tempfile
    from pathlib import Path
    with tempfile.TemporaryDirectory() as d:
        if "--search" in sys.argv:
            i = sys.argv.index("--search")
            search(Path(d), int(sys.argv[i + 1]), int(sys.argv[i + 2]))
            sys.exit(0)
        data = write_golden(Path(d))
    pp.GOLDEN.write_text(json.dumps(data, indent=1) + "\n")
    for config in pp.CONFIGS:
        print(config, "held", [st["held"] for st in data[config]["streams"]],
              "of", [len(st["tokens"]) for st in data[config]["streams"]])
