"""Deterministic, checkpointable synthetic LM data pipeline (copy of
``repro.data.pipeline``: same numpy generator, so one seed gives both
packages the same token stream).

The paper's ETTR model charges every restart a recovery cost that includes
re-establishing the input pipeline; a *checkpointable* pipeline (state =
(seed, step)) makes restart cheap and exactly reproducible — a restarted
run consumes the same token stream it would have seen without the failure,
which is what makes the runtime's bit-exact resume test possible.

Data: a mixture of synthetic "documents" drawn from a power-law unigram
distribution with per-document Markov structure, packed into fixed-length
sequences.  Entirely stateless-functional: batch(i) is a pure function of
(seed, i), so any worker can compute any shard of any step.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # synthetic structure
    zipf_a: float = 1.2
    doc_len_mean: float = 512.0
    bos_id: int = 1
    eos_id: int = 2


@dataclass
class PipelineState:
    """Everything needed to resume: goes into every checkpoint."""

    step: int
    config: DataConfig

    def to_dict(self) -> dict:
        return {"step": self.step, "seed": self.config.seed}


class SyntheticLMPipeline:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        probs = 1.0 / np.arange(3, cfg.vocab_size, dtype=np.float64) ** cfg.zipf_a
        self._probs = probs / probs.sum()
        self._state = PipelineState(0, cfg)

    @property
    def state(self) -> PipelineState:
        return self._state

    def restore(self, step: int) -> None:
        self._state = PipelineState(step, self.cfg)

    def _rng_for(self, step: int, sample: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, step, sample]))

    def _sample_sequence(self, rng: np.random.Generator) -> np.ndarray:
        cfg = self.cfg
        out = np.empty(cfg.seq_len + 1, dtype=np.int32)
        pos = 0
        while pos < len(out):
            doc_len = max(8, int(rng.exponential(cfg.doc_len_mean)))
            doc_len = min(doc_len, len(out) - pos)
            toks = rng.choice(len(self._probs), size=doc_len,
                              p=self._probs).astype(np.int32) + 3
            # cheap Markov structure: every other token repeats with p=.3
            rep = rng.random(doc_len) < 0.3
            rep[0] = False
            toks[rep] = toks[np.maximum(np.nonzero(rep)[0] - 1, 0)]
            toks[0] = cfg.bos_id
            if doc_len > 1:
                toks[-1] = cfg.eos_id
            out[pos:pos + doc_len] = toks
            pos += doc_len
        return out

    def batch_at(self, step: int) -> dict:
        """Pure function of (seed, step): (B, S+1) int32 tokens."""
        b = np.stack([
            self._sample_sequence(self._rng_for(step, i))
            for i in range(self.cfg.global_batch)])
        return {"tokens": b}

    def next_batch(self) -> dict:
        out = self.batch_at(self._state.step)
        self._state = PipelineState(self._state.step + 1, self.cfg)
        return out
