"""Drives the continuous-batching engine
(``repro_torch.serving.ContinuousEngine``): each call is one ``serve`` of
a backlog of ``backlog`` requests, admitted into ``slots`` slots as they
free up, one decode step for every slot at a time."""

from __future__ import annotations

import time

from perfbench.lib.call import Call


class Driver:
    kind = "continuous"

    def __init__(self, api, params, traffic, gen, seed, device):
        from repro_torch.serving import ContinuousEngine
        self.engine = ContinuousEngine(
            api, params, batch_slots=int(traffic["slots"]),
            cache_len=int(traffic["cache_len"]), seed=seed, device=device)
        self.gen = gen

    def _serve(self, reqs):
        from repro_torch.serving import Request
        return self.engine.serve([
            Request(uid=r.uid, prompt=r.prompt,
                    max_new_tokens=r.max_new_tokens) for r in reqs])

    def warm_up(self) -> None:
        """Every admission prefill length the mix uses, and the decode
        step (one shape for all slots)."""
        self._serve(self.gen.warm_up())

    def call(self, n=None) -> Call:
        reqs = self.gen.batch(n)
        t0 = time.perf_counter()
        done = self._serve(reqs)
        return Call(reqs, done, t0, time.perf_counter(),
                    stats=self.engine.last_stats, kind=self.kind)

    def close(self) -> None:
        self.engine = None
