"""The control of ``correct``: the reference itself, computed in the
nearest precision below the configuration's (TF32 convs and matmuls for
f32 with TF32 off), put in the program's place and judged as a run judges
the program.  It has to come out not correct.

    python3 bench_h100/harness/control.py --workload <cell> --seeds <n> ... [--precision tf32|float32]

Not part of a benchmark run.  It serves the first ``count`` sentences of
the seed's schedule in order (the glow noise drawn as the interface draws
it), judges the same sample a run judges and prints one JSON line of the
numbers beside the cell's limits.  ``--precision float32`` runs the
reference against itself (every number 0).
"""

from __future__ import annotations

import argparse
import json
import os
import sys


ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def serve_reference(st, ref, count: int, tf32: bool) -> tuple:
    """(records, noise shapes, picks, client): the first ``count`` schedule
    sentences as the cell's client records them, at the shapes at which
    the program's interface would run them (the client's ``shapes``) and
    with what the client gives the program, the sampled ones synthesized
    by the reference with TF32 on or off."""
    from bench_h100.harness import check, spec

    client = spec.client(st.mix["client"])(st, None)
    records, shapes = [], []
    for i, (_, p) in enumerate(st.schedule[:count]):
        pad, frames = client.shapes(i)
        records.append(dict(item=i, phones=p, phone_bucket=pad, noise_index=i, frames=0))
        shapes.append(st.family.noise_shape(st.config, frames))
    sample = check.Sample(st.seed)
    for i, rec in enumerate(records):
        sample.offer(i, rec["phones"])
    picks = sample.picks(records)
    draws = ref.noise(st.seed, shapes, set(picks))
    check.set_tf32(tf32)
    try:
        for i in picks:
            out = ref.synthesize(st.features[st.schedule[i][0]], records[i]["phone_bucket"],
                                 draws[i], **(client.given(i) or {}))
            records[i].update(client.served(out))
    finally:
        check.set_tf32(False)
    return records, shapes, picks, client


def control(cell_name: str, seed: int, precision: str = "tf32", count: int = 96,
            device="cuda", config_override=None, mix_override=None) -> dict:
    from bench_h100.harness import check, run

    st = run.prepare(cell_name, seed, device, config_override, mix_override)
    ref = st.family.Reference(st.tts, st.voc, st.embedding, device)
    records, shapes, picks, client = serve_reference(st, ref, count, precision == "tf32")
    features = {i: ref.fe.string_to_features(st.schedule[i][0]) for i in picks}
    numbers, ties = check.judge(ref, records, picks, st.schedule, features, seed, shapes,
                                client.given)
    failed = [k for k, v in numbers.items() if not v <= st.limits[k]]
    return {"cell": cell_name, "seed": seed, "precision": precision, "near_ties": ties,
            "correct": not failed, "numbers": numbers, "limits": st.limits}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--precision", choices=("tf32", "float32"), default="tf32")
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    for seed in args.seeds:
        print(json.dumps(control(args.workload, seed, args.precision)), flush=True)


if __name__ == "__main__":
    main()
