"""BatchTranscriber.transcribe's resident PCM stack (whisper_tpu_torch's
parallel/batch.py), built by writing each stream's row once into the
transcriber's reused staging buffer: torch.equal (shape, dtype, values) to
the stack built the earlier way (each stream padded into a copy of its
own, then copied into a fresh zeroed stack), kept here as the reference;
pad_audio, now written through the same row writer, as it was; and the
segments of transcribe the same as on the non-resident path."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from whisper_tpu_torch import WhisperContext, full_default_params  # noqa: E402
from whisper_tpu_torch.audio.mel import pad_audio  # noqa: E402
from whisper_tpu_torch.constants import CHUNK_SIZE, N_FFT  # noqa: E402
from whisper_tpu_torch.parallel.batch import BatchTranscriber  # noqa: E402
from whisper_tpu_torch.utils.trace import TRACE  # noqa: E402

# micro dims with a real-layout vocab, as tests/test_torch_trace.py's
MICRO = (51864, 32, 64, 4, 2, 48, 64, 4, 3, 80)
B = 4
# a padded length of exactly two 30 s chunks (pad_audio adds 30 s + N_FFT)
EXACT = 16000 * CHUNK_SIZE - N_FFT


@pytest.fixture(scope="module")
def ctx():
    return WhisperContext.from_random(seed=7, device="cpu", dims=MICRO,
                                      compute_dtype=torch.float32)


def _params():
    p = full_default_params()
    p.print_progress = False
    p.language = "en"
    p.temperature_inc = 0.0
    p.no_timestamps = True
    p.max_tokens = 8
    return p


def _pad_as_before(samples):
    """pad_audio's padded copy as it was written before pad_audio_into."""
    n = len(samples)
    dtype = np.int16 if samples.dtype == np.int16 else np.float32
    padded = np.zeros(n + 16000 * CHUNK_SIZE + N_FFT, dtype=dtype)
    padded[N_FFT // 2:N_FFT // 2 + n] = samples
    padded[:N_FFT // 2] = samples[1:1 + N_FFT // 2][::-1]
    return padded


def _stack_as_before(streams, batch):
    """The resident stack as transcribe built it before the staging buffer:
    every stream padded on its own, then copied into a fresh zeroed stack."""
    padded = []
    for pcm in streams:
        arr = np.asarray(pcm)
        if arr.dtype != np.int16:
            arr = arr.astype(np.float32)
        if len(arr) < 1 + N_FFT // 2:
            arr = np.pad(arr, (0, 1 + N_FFT // 2 - len(arr)))
        padded.append(_pad_as_before(arr))
    gran = 16000 * CHUNK_SIZE
    s_max = -(-max(len(r) for r in padded) // gran) * gran
    n_rows = -(-len(padded) // batch) * batch
    all_i16 = all(r.dtype == np.int16 for r in padded)
    stack = np.zeros((n_rows, s_max), np.int16 if all_i16 else np.float32)
    for i, row in enumerate(padded):
        if not all_i16 and row.dtype == np.int16:
            row = row.astype(np.float32) / 32768.0
        stack[i, :len(row)] = row
    return torch.from_numpy(stack)


def _streams(lengths, kinds, seed=0):
    """Streams of the given lengths; kind "i16", "f32" or "f64"."""
    rng = np.random.RandomState(seed)
    out = []
    for n, kind in zip(lengths, kinds):
        x = rng.randn(n) * 0.2
        if kind == "i16":
            x = (x * 32768).clip(-32768, 32767).astype(np.int16)
        elif kind == "f32":
            x = x.astype(np.float32)
        out.append(x)
    return out


def _staged(bt, streams):
    arrs = bt._resident_pcm(streams)
    assert arrs is not None
    return bt._upload_pcm(arrs)


CASES = {
    # one shorter than the reflect pad, one exactly two chunks padded
    "int16": ([16000, 50, EXACT, 33333, 1], ["i16"] * 5),
    "float32": ([16000, 200, EXACT, 70000], ["f32"] * 4),
    "float64": ([9000, 480000], ["f64"] * 2),
    "mixed": ([16000, 50, EXACT, 20000, 7], ["i16", "f32", "i16", "f64",
                                             "i16"]),
    # a stream count that is a multiple of B, and one that is not
    "rows_whole": ([1000] * 4, ["i16"] * 4),
    "rows_ragged": ([1000] * 6, ["f32"] * 6),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_staged_stack_equals_the_padded_stack(ctx, case):
    streams = _streams(*CASES[case])
    bt = BatchTranscriber(ctx, batch_size=B, params=_params(),
                          device_mel=True)
    got = _staged(bt, streams)
    want = _stack_as_before(streams, B)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(got, want)


@pytest.mark.parametrize("kinds", [("i16", "i16"), ("f32", "f32"),
                                   ("i16", "f32")], ids=["int16", "float32",
                                                         "dtype_changes"])
def test_second_call_leaves_nothing_of_the_first(ctx, kinds):
    """The second call's shorter streams reuse the first call's buffer:
    every sample past them reads zero, not the first call's data."""
    bt = BatchTranscriber(ctx, batch_size=B, params=_params(),
                          device_mel=True)
    first = _streams([1_000_000, 700_000, 900_000, 5, 400_000],
                     [kinds[0]] * 5, seed=1)
    second = _streams([30_000, 50], [kinds[1]] * 2, seed=2)
    got = _staged(bt, first)
    assert torch.equal(got, _stack_as_before(first, B))
    ptr = bt._stage.data_ptr()
    got = _staged(bt, second)
    assert bt._stage.data_ptr() == ptr     # the same buffer, refilled
    assert torch.equal(got, _stack_as_before(second, B))


@pytest.mark.parametrize("kind", ["i16", "f32", "f64"])
def test_pad_audio_is_the_padding_as_before(kind):
    """pad_audio, now written through pad_audio_into, gives the same
    padded copy (dtype and values) and frame counts."""
    for x in _streams([201, 16000, EXACT], [kind] * 3, seed=3):
        padded, n_len, n_len_org = pad_audio(x)
        want = _pad_as_before(x)
        assert padded.dtype == want.dtype and np.array_equal(padded, want)
        assert n_len == (len(want) - N_FFT) // 160
        assert n_len_org == 1 + (len(x) + N_FFT // 2 - N_FFT) // 160


def test_residency_is_decided_by_the_padded_bytes(ctx):
    """The same test as on each stream's pad_audio copy: the sum of the
    padded streams' bytes (int16 rows at 2 bytes, whatever the stack's
    dtype) within RESIDENT_BYTES; off under device_mel=False."""
    streams = _streams([16000, 9000], ["i16", "f32"])
    padded = sum(_pad_as_before(x).nbytes for x in streams)
    bt = BatchTranscriber(ctx, batch_size=B, params=_params(),
                          device_mel=True)
    bt.RESIDENT_BYTES = padded
    assert bt._resident_pcm(streams) is not None
    bt.RESIDENT_BYTES = padded - 1
    assert bt._resident_pcm(streams) is None
    assert bt._resident_pcm([]) is None
    host = BatchTranscriber(ctx, batch_size=B, params=_params())
    assert host._resident_pcm(streams) is None


def _segments(result):
    return [[(s.t0, s.t1, [t.id for t in s.tokens]) for s in segs]
            for segs in result]


@pytest.mark.parametrize("kind", ["i16", "f32"])
def test_transcribe_equals_the_streamed_windows(ctx, kind):
    """transcribe over the staged stack gives the segments of the path
    that uploads each iteration's windows (RESIDENT_BYTES = 0); on the
    CPU nothing is staged through pinned memory."""
    streams = _streams([16000 * 35, 16000 * 62, 16000 * 4], [kind] * 3)
    resident = BatchTranscriber(ctx, batch_size=2, params=_params(),
                                device_mel=True)
    streamed = BatchTranscriber(ctx, batch_size=2, params=_params(),
                                device_mel=True)
    streamed.RESIDENT_BYTES = 0
    TRACE.drain()
    TRACE.enable()
    try:
        got = resident.transcribe(streams)
        recs = TRACE.drain()
        want = streamed.transcribe(streams)
        recs_streamed = TRACE.drain()
    finally:
        TRACE.disable()
        TRACE.drain()
    assert all(got) and _segments(got) == _segments(want)
    names = [r.name for r in recs]
    assert names.count("upload") == 1 and "pcm_staged" not in names
    assert [st.pcm_padded for st in resident.last_states] == [None] * 3
    assert "upload" not in [r.name for r in recs_streamed]
    assert [st.seek_end for st in resident.last_states] == \
        [st.seek_end for st in streamed.last_states]
