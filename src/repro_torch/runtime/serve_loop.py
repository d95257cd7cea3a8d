"""Batched serving loop with prefill/decode phases + fault-tolerant restart
(after ``repro.runtime.serve_loop``).

Requests are prefilled in one batch, then decoded greedily step by step
against the KV cache.  On an injected crash the loop drops the batch's
in-flight state and replays the whole batch from its prompts.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.steps import make_decode_step, make_prefill_step
from repro_torch.models.transformer import Transformer
from repro_torch.runtime.fault_injection import FaultInjector, SimulatedFault


def resolve_device(device: Optional[torch.device | str]) -> torch.device:
    """``None`` means the card; asking for CUDA without one raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev


@dataclass
class ServeConfig:
    batch: int = 4
    prompt_len: int = 32
    max_new_tokens: int = 16
    seed: int = 0


@dataclass
class ServeReport:
    completed_requests: int
    retries: int
    tokens_generated: int
    wall_s: float
    outputs: np.ndarray
    prefill_s: float = 0.0  # the last (successful) attempt's prefill
    decode_s: float = 0.0   # ... and its decode steps


class Server:
    def __init__(self, cfg: ArchConfig, scfg: ServeConfig,
                 injector: Optional[FaultInjector] = None, *,
                 device: Optional[torch.device | str] = None,
                 dtype: torch.dtype = torch.bfloat16,
                 params: Optional[dict[str, torch.Tensor]] = None):
        self.cfg = cfg
        self.scfg = scfg
        self.injector = injector or FaultInjector()
        self.device = resolve_device(device)
        self.model = Transformer(cfg, device=self.device, dtype=dtype, seed=scfg.seed)
        if params is not None:  # e.g. converted reference weights
            self.model.load_state_dict(params, strict=True)
        self.prefill = make_prefill_step(self.model)
        self.decode = make_decode_step(self.model)

    def _requests(self) -> np.ndarray:
        rng = np.random.default_rng(self.scfg.seed)
        return rng.integers(3, self.cfg.vocab_size,
                            (self.scfg.batch, self.scfg.prompt_len),
                            dtype=np.int32)

    def _batch(self, prompts: np.ndarray) -> dict:
        """The prefill's batch: the prompts, and for an encoder-decoder
        config the reference Server's stub frames, zeros (B, prompt_len,
        d_model) in bf16."""
        batch = {"tokens": torch.from_numpy(prompts).long().to(self.device)}
        if self.cfg.enc_dec:
            batch["frames"] = torch.zeros((self.scfg.batch, self.scfg.prompt_len,
                                           self.cfg.d_model), dtype=torch.bfloat16,
                                          device=self.device)
        return batch

    def _now(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def run(self) -> ServeReport:
        sc = self.scfg
        t0 = time.time()
        prompts = self._requests()
        retries = 0
        step_counter = 0
        while True:
            try:
                t_start = self._now()
                logits, cache = self.prefill(self._batch(prompts))
                out = np.zeros((sc.batch, sc.max_new_tokens), np.int32)
                tok = logits[:, -1].argmax(-1)
                t_prefill = self._now()
                for i in range(sc.max_new_tokens):
                    fault = self.injector.poll(step_counter)
                    step_counter += 1
                    if fault is not None and fault.kind == "crash":
                        raise SimulatedFault(fault)
                    out[:, i] = tok.cpu().numpy()
                    logits, cache = self.decode(cache, tok[:, None])
                    tok = logits[:, -1].argmax(-1)
                t_end = self._now()
                break
            except SimulatedFault:
                retries += 1
                if retries > 8:
                    raise
        return ServeReport(
            completed_requests=sc.batch, retries=retries,
            tokens_generated=int(sc.batch * sc.max_new_tokens),
            wall_s=time.time() - t0, outputs=out,
            prefill_s=t_prefill - t_start, decode_s=t_end - t_prefill)
