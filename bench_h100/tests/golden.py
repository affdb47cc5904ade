"""What a tiny run of a cell gives, for ``test_bench_golden.py``: the
schedule, the weights, the shapes each record ran at and the check's
numbers, taken through the harness's stable entry points only
(``run.prepare``, ``run.Run``, ``serve.Client.run``), so that one copy of
this file reads an older harness as well as this one.

    python3 bench_h100/tests/golden.py OUT.json

from a checkout's root writes the observations of ``CASES`` there.  The
window serves a fixed number of requests in place of ``--seconds``, so
that the records do not depend on the CPU's speed.
"""

import hashlib
import json
import sys
from pathlib import Path

CASES = [(cell, seed) for cell in ("toucan_hifigan.interactive", "toucan_bigvgan.read_aloud")
         for seed in (2**31 + 5, 3_000_000_017)]
REQUESTS = 6          # calls, or pages of 4 sentences, a window
WINDOW_S = 1.0
RECORD_KEYS = ("item", "phones", "noise_index", "noise_shape", "rows", "phone_bucket",
               "decoder_frames", "vocoder_frames", "frames")


def digest(obj) -> str:
    return hashlib.sha256(json.dumps(obj, sort_keys=True).encode()).hexdigest()


def state_digest(*modules) -> str:
    h = hashlib.sha256()
    for m in modules:
        for k, v in sorted(m.state_dict().items()):
            h.update(k.encode())
            h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def observe(cell: str, seed: int, **kw) -> dict:
    """The observations of one tiny run of ``cell`` on the CPU, one thread."""
    import torch

    import tiny
    from bench_h100.harness import run, serve
    from bench_h100.roofline import model_flops

    seen = {}
    prepare, run_cls, window = run.prepare, run.Run, serve.Client.run

    def prepared(*args, **kwargs):
        st = prepare(*args, **kwargs)
        seen["schedule"] = digest(st.schedule)
        seen["weights"] = state_digest(st.tts, st.voc)
        seen["embedding"] = digest([float(x) for x in st.embedding])
        return st

    def fixed_window(client, seconds):
        i = 0
        for _ in range(REQUESTS):
            i = client.request(i)
        return WINDOW_S

    class Seen(run_cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            seen["run"] = self

    threads = torch.get_num_threads()
    run.prepare, run.Run, serve.Client.run = prepared, Seen, fixed_window
    torch.set_num_threads(1)
    try:
        cfg, mix = cell.split(".")
        out, _ = run.execute(cell, seed, WINDOW_S, False, device="cpu",
                             config_override=tiny.config(cfg), mix_override=tiny.mix(mix), **kw)
    finally:
        run.prepare, run.Run, serve.Client.run = prepare, run_cls, window
        torch.set_num_threads(threads)
    r = seen.pop("run")
    records = [{k: (list(rec[k]) if isinstance(rec.get(k), tuple) else rec.get(k))
                for k in RECORD_KEYS} for rec in r.records]
    for rec, full in zip(records, r.records):
        if "durations" in full:
            rec["durations"] = [int(d) for d in full["durations"]]
    return dict(seen, records=records, correct=out["correct"],
                checks={k: v["value"] for k, v in out["checks"].items()},
                audio_s_per_s=out["metrics"]["audio_s_per_s"]["value"],
                flops=sum(model_flops.sentence(r.config, x["phones"], x["frames"])
                          for x in r.served))


def main(path):
    here = Path(__file__).resolve().parent
    sys.path[:0] = [str(here.parents[1]), str(here)]
    json.dump({f"{cell} {seed}": observe(cell, seed) for cell, seed in CASES},
              open(path, "w"), indent=1)


if __name__ == "__main__":
    main(sys.argv[1])
