"""``call``: one ``__call__`` at a time, the next sentence when the wave is
on the host (the interactive demo, a screen reader)."""

from __future__ import annotations

import time

from bench_h100.harness.serve import SAMPLES_PER_FRAME, Client


class CallClient(Client):
    def warm(self):
        for i in self.warm_items():
            self._call(i)

    def _call(self, i):
        text = self._item(i)[0]
        return self.iface(text, return_duration_pitch_energy=True,
                          **(self.given(i % len(self.schedule)) or {}))

    def served(self, synthesis: dict) -> dict:
        return dict(super().served(synthesis), durations=synthesis["durations"],
                    pitch=synthesis["pitch"], energy=synthesis["energy"])

    def request(self, i):
        text, phones = self._item(i)
        draw, step = len(self.draws), len(self.steps)
        rec = dict(item=i % len(self.schedule), phones=phones, t_send=time.perf_counter())
        try:
            with self.span("bench.request"):
                wave, dur, pitch, energy = self._call(i)
        except Exception as exc:  # a failed request counts, the loop goes on
            rec.update(error=repr(exc))
        else:
            rec.update(durations=dur, pitch=pitch, energy=energy,
                       frames=len(wave) // SAMPLES_PER_FRAME)
            keep, drop = self.sample.offer(len(self.records), phones)
            if keep:
                rec["wave"] = wave
            if drop is not None:
                del self.records[drop]["wave"]
        rec["t_done"] = time.perf_counter()
        self._ran(rec, draw, step)
        self.records.append(rec)
        return i + 1


CLIENT = CallClient
