#!/usr/bin/env python3
"""How near the card's and the CPU's alignments of one cloned reference come
to a tie (the inputs of ``chip_smoke.py::phase_clone``).

On the card: the full-size seeded interface and aligner of ``chip_smoke.py``,
the reference wave synthesized twice (how far it moves between calls), the
reference's log-mel card against CPU, then a few fresh 5-step fine-tunes of
the loaded aligner (cuDNN's LSTM backward is not deterministic), each with
its logits card against CPU (each side on its own mel, both on the card's
mel, and in float64) and, for MAS and dijkstra, whether the two sides'
alignments are equal or part on a near-tie, with the margin.

    python3 scripts/clone_near_ties.py [--trials 4]
"""

import argparse
import copy
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from toucan_tpu_torch.infer.cloner import UtteranceCloner  # noqa: E402
from toucan_tpu_torch.infer.interface import ToucanTTSInterface  # noqa: E402
from toucan_tpu_torch.kernels import build  # noqa: E402
from toucan_tpu_torch.models.aligner import alignment_from_logits  # noqa: E402
from toucan_tpu_torch.models.toucan_tts import ToucanTTS, ToucanTTSConfig  # noqa: E402
from toucan_tpu_torch.models.vocoders.hifigan import HiFiGANGenerator  # noqa: E402


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--trials", type=int, default=4)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("clone_near_ties: no CUDA device is visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    build.build(["flash_rel_attention", "hifigan_stage"])
    torch.manual_seed(chip_smoke.SEED)
    tts_sd, voc_sd = ToucanTTS(ToucanTTSConfig()).state_dict(), HiFiGANGenerator().state_dict()
    iface = ToucanTTSInterface(tts_sd, voc_sd, seed=chip_smoke.SEED)
    cpu = ToucanTTSInterface(tts_sd, voc_sd, device="cpu", seed=chip_smoke.SEED)
    text = chip_smoke.LONG_TEXT
    durations = np.full(len(iface.text2phone.string_to_features(text)),
                        chip_smoke.CLONE_FRAMES_PER_PHONE)
    ref, again = iface(text, durations=durations), iface(text, durations=durations)
    print(f"reference wave, two calls on the card: max_abs_diff={np.abs(ref - again).max():.3e}"
          f" (peak {np.abs(ref).max():.3e})")
    sd = chip_smoke.seeded_aligner_state(chip_smoke.SEED + 4)
    sides = (UtteranceCloner(iface, sd), UtteranceCloner(cpu, sd))
    loaded = sides[0].aligner
    refs = [c.prepare(text, ref, sr=24000) for c in sides]
    mels = [r.mel.double().cpu().numpy() for r in refs]
    diff = np.abs(mels[0] - mels[1])
    worst = np.unravel_index(diff.argmax(), diff.shape)
    power = np.abs(10.0 ** mels[0] - 10.0 ** mels[1]).max() / (10.0 ** mels[1]).max()
    print(f"mel, card against CPU: log10 max_abs_diff={diff.max():.3e} at frame {worst[0]}, bin "
          f"{worst[1]} (card {mels[0][worst]:.4f}, CPU {mels[1][worst]:.4f}); in power "
          f"{power:.3e} of the peak")
    ids = refs[0].token_ids
    for trial in range(args.trials):
        tuned = sides[0]._fine_tune_aligner(refs[0].mel, ids)
        sides[0].aligner, sides[1].aligner = tuned, copy.deepcopy(tuned).cpu()
        mel64 = refs[0].mel.double()
        logits = {
            "own mel": [c.logits(c.aligner, r.mel) for c, r in zip(sides, refs)],
            "card's mel": [c.logits(c.aligner, refs[0].mel.to(c.device)) for c in sides],
            "float64": [c.logits(copy.deepcopy(c.aligner).double(), mel64.to(c.device))
                        for c in sides]}
        print(f"fine-tune {trial}: logits card against CPU: " + ", ".join(
            f"{name} {np.abs(lg[0] - lg[1]).max():.3e}" for name, lg in logits.items()))
        for method in ("MAS", "dijkstra"):
            for name, lg in logits.items():
                aligns = [alignment_from_logits(x, ids, method) for x in lg]
                line = chip_smoke.check_alignments(method, [x[:, ids] for x in lg], aligns)
                print(f"  {method}, {name}: {line}")
        sides[0].aligner = loaded
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
