"""Drives the wave engine (``repro_torch.serving.Engine``): each call is
one ``serve`` of ``backlog`` requests, in waves of ``slots``, prompts
right-padded to the wave's longest, every slot decoding in step."""

from __future__ import annotations

import time

from perfbench.lib.call import Call


class Driver:
    kind = "wave"

    def __init__(self, api, params, traffic, gen, seed, device):
        from repro_torch.serving import Engine
        self.engine = Engine(api, params, batch_slots=int(traffic["slots"]),
                             cache_len=int(traffic["cache_len"]), seed=seed,
                             device=device)
        self.gen = gen

    def _serve(self, reqs):
        from repro_torch.serving import Request
        return self.engine.serve([
            Request(uid=r.uid, prompt=r.prompt,
                    max_new_tokens=r.max_new_tokens) for r in reqs])

    def warm_up(self) -> None:
        """A wave of each prompt length (the prefill is as wide as the
        slots, whatever the wave holds) and its decode steps."""
        for r in self.gen.warm_up():
            self._serve([r])

    def call(self, n=None) -> Call:
        reqs = self.gen.batch(n)
        t0 = time.perf_counter()
        done = self._serve(reqs)
        return Call(reqs, done, t0, time.perf_counter(), kind=self.kind)

    def close(self) -> None:
        self.engine = None
