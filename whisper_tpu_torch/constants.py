"""Global constants of the Whisper ASR pipeline.

Mirrors the reference constants (reference: include/whisper.h:33-36,
src/whisper.cpp:145-146) so that every timing / framing computation matches
bit-for-bit.
"""

SAMPLE_RATE = 16000       # WHISPER_SAMPLE_RATE
N_FFT = 400               # WHISPER_N_FFT (window size)
HOP_LENGTH = 160          # WHISPER_HOP_LENGTH
CHUNK_SIZE = 30           # WHISPER_CHUNK_SIZE, seconds per encoder window

N_SAMPLES_PER_CHUNK = SAMPLE_RATE * CHUNK_SIZE    # 480000
N_FRAMES_PER_CHUNK = N_SAMPLES_PER_CHUNK // HOP_LENGTH  # 3000 mel frames / 30 s

MAX_DECODERS = 8          # WHISPER_MAX_DECODERS

# ggml legacy model-file magic (reference: src/whisper.cpp:1510-1516)
GGML_FILE_MAGIC = 0x67676D6C

# frames of mel per centisecond tick: timestamps are in units of 10 ms
TICKS_PER_SECOND = 100

# model-type inference from n_audio_layer (reference: src/whisper.cpp:1538-1560)
MODEL_TYPE_BY_AUDIO_LAYERS = {
    4: "tiny",
    6: "base",
    12: "small",
    24: "medium",
    32: "large",
}
