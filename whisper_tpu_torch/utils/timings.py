"""Per-phase timing counters (copy of whisper_tpu.utils.timings;
reference: src/whisper.cpp:874-887, 4251-4303)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Timings:
    t_start_us: int = 0
    t_load_us: int = 0
    t_mel_us: int = 0
    t_sample_us: int = 0
    t_encode_us: int = 0
    t_decode_us: int = 0
    t_batchd_us: int = 0
    t_prompt_us: int = 0

    n_sample: int = 0
    n_encode: int = 0
    n_decode: int = 0
    n_batchd: int = 0
    n_prompt: int = 0
    n_fail_p: int = 0
    n_fail_h: int = 0

    # the port's host-side passes: the DTW cross-QK re-decode and the host
    # DTW (normalize, median filter, backtrace) a window; the host filter
    # chain with its grammar mask a decoder step (t_grammar_us also holds
    # the speculative chunks' first-token masks), the speculative path's
    # device chunks and its restarts after a mismatch
    t_dtw_qk_us: int = 0
    t_dtw_host_us: int = 0
    n_dtw: int = 0
    t_grammar_us: int = 0
    n_grammar: int = 0
    n_grammar_chunk: int = 0
    n_grammar_restart: int = 0

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, 0)

    def summary(self) -> dict:
        """whisper_timings equivalent: average ms per phase."""
        def avg(t, n):
            return (t / 1000.0) / max(1, n)
        return {
            "sample_ms": avg(self.t_sample_us, self.n_sample),
            "encode_ms": avg(self.t_encode_us, self.n_encode),
            "decode_ms": avg(self.t_decode_us, self.n_decode),
            "batchd_ms": avg(self.t_batchd_us, self.n_batchd),
            "prompt_ms": avg(self.t_prompt_us, self.n_prompt),
            "mel_ms": self.t_mel_us / 1000.0,
        }

    def print(self) -> None:
        """whisper_print_timings."""
        import sys
        s = self.summary()
        print(f"whisper_tpu_torch: mel time = {self.t_mel_us / 1000.0:8.2f} ms", file=sys.stderr)
        for phase, n in (("encode", self.n_encode), ("decode", self.n_decode),
                         ("prompt", self.n_prompt)):
            t = getattr(self, f"t_{phase}_us") / 1000.0
            per = t / max(1, n)
            print(f"whisper_tpu_torch: {phase} time = {t:8.2f} ms / {n:5d} runs "
                  f"({per:8.2f} ms per run)", file=sys.stderr)
