"""The port's spans and counters on the serving path (``utils/profiling.py``,
``infer/interface.py``, ``infer/capture.py``), on the CPU at tiny widths.

Each entry point's spans form the tree its docstring names, under one
request id; the same spans land in a ``torch.profiler`` trace; with
nothing tracing, ``span`` is the shared no-op and no record function of
the profiler is entered; the counters equal the frames returned and run,
and count a bucket made outside ``precompile`` as made live.
"""

import collections
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from toucan_tpu_torch.infer.interface import (FRAMES_PER_PHONE, PHONE_BUCKET, SAMPLES_PER_FRAME,
                                              SENTENCE_JOIN_SILENCE, ToucanTTSInterface,
                                              _frame_bucket)
from toucan_tpu_torch.models.toucan_tts import ToucanTTS, ToucanTTSConfig
from toucan_tpu_torch.models.vocoders.hifigan import HiFiGANGenerator
from toucan_tpu_torch.utils import profiling
from toucan_tpu_torch.utils.profiling import SpanLog, span

torch.set_num_threads(2)

TINY = dict(adim=32, aheads=2, enc_layers=1, enc_units=64, dec_layers=1, dec_units=64,
            duration_layers=1, pitch_layers=1, energy_layers=1, duration_chans=16,
            pitch_chans=16, energy_chans=16, glow_blocks=2, glow_hidden=16,
            utt_embed_dim=64, lang_embs=100)
TEXTS = ["~hɛlˈoʊ wˈɜːld~#", "~ə ʃˈɔːɹt wˈʌn~#"]
# a step: the acoustic half's replay, the read of its mel lengths, the
# vocoder's replay
STEP = [("toucan.replay", []), ("toucan.fetch", []), ("toucan.replay", [])]
DISPATCH = ("toucan.dispatch", [("toucan.frontend", []), ("toucan.stage", []), *STEP])


def make_interface():
    torch.manual_seed(0)
    config = ToucanTTSConfig(**TINY)
    return ToucanTTSInterface(ToucanTTS(config).state_dict(),
                              HiFiGANGenerator(channels=32).state_dict(), config=config,
                              vocoder=HiFiGANGenerator(channels=32), device="cpu",
                              use_g2p=False)


@pytest.fixture(scope="module")
def iface():
    return make_interface()


def tree(spans, parent=None):
    return [(s.name, tree(spans, i)) for i, s in enumerate(spans) if s.parent == parent]


def assert_one_request(iface, log):
    rids = {s.rid for s in log.spans}
    assert rids == {iface.counters["requests"]}
    for s in log.spans:
        assert s.end_ns >= s.start_ns
        if s.parent is not None:
            outer = log.spans[s.parent]
            assert outer.start_ns <= s.start_ns and s.end_ns <= outer.end_ns


def test_call_spans_share_the_request_id(iface, tmp_path):
    with SpanLog() as log:
        iface(TEXTS[0], input_is_phones=True, return_duration_pitch_energy=True)
    assert tree(log.spans) == [("toucan.call", [DISPATCH, ("toucan.fetch", [])])]
    assert_one_request(iface, log)
    log.write(tmp_path / "spans.jsonl")
    lines = [json.loads(x) for x in (tmp_path / "spans.jsonl").read_text().splitlines()]
    assert [x["name"] for x in lines] == [s.name for s in log.spans]
    assert lines[0]["rid"] == iface.counters["requests"]


def test_read_to_file_spans_index_each_sentence(iface, tmp_path):
    with SpanLog() as log:
        iface.read_to_file(TEXTS, tmp_path / "page.wav", input_is_phones=True)
    fetch = ("toucan.fetch", [])
    assert tree(log.spans) == [("toucan.read_to_file",
                                [DISPATCH, DISPATCH, fetch, fetch, ("toucan.write", [])])]
    assert [s.index for s in log.spans if s.name == "toucan.dispatch"] == [0, 1]
    assert_one_request(iface, log)


def test_synthesize_batch_spans(iface):
    with SpanLog() as log:
        iface.synthesize_batch(TEXTS, input_is_phones=True)
    assert tree(log.spans) == [("toucan.batch", [("toucan.frontend", []), ("toucan.stage", []),
                                                 *STEP, ("toucan.fetch", [])])]
    assert_one_request(iface, log)


class CountingRecordFunction:
    """The profiler's record function, counting the spans it enters."""
    entered = []
    real = profiling._RecordFunctionFast

    def __init__(self, name):
        self.name, self.inner = name, self.real(name)

    def __enter__(self):
        CountingRecordFunction.entered.append(self.name)
        return self.inner.__enter__()

    def __exit__(self, *exc):
        return self.inner.__exit__(*exc)


def test_spans_land_in_the_profiler_trace(iface, monkeypatch):
    monkeypatch.setattr(profiling, "_RecordFunctionFast", CountingRecordFunction)
    CountingRecordFunction.entered = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        iface(TEXTS[1], input_is_phones=True)
    in_trace = collections.Counter(e.name for e in prof.events() if e.name.startswith("toucan."))
    assert in_trace == collections.Counter(CountingRecordFunction.entered)
    assert set(in_trace) == {"toucan.call", "toucan.dispatch", "toucan.frontend",
                             "toucan.stage", "toucan.replay", "toucan.fetch"}


def test_span_is_the_shared_noop_while_nothing_traces(iface, monkeypatch):
    monkeypatch.setattr(profiling, "_RecordFunctionFast", CountingRecordFunction)
    CountingRecordFunction.entered = []
    assert span("toucan.call", 1) is span("toucan.fetch") is profiling._NOOP
    iface(TEXTS[0], input_is_phones=True)
    iface.synthesize_batch(TEXTS, input_is_phones=True)
    assert CountingRecordFunction.entered == []


def test_counters_follow_frames_and_live_buckets(tmp_path):
    iface = make_interface()
    iface.precompile(phone_buckets=(PHONE_BUCKET,))
    # the text -> mel bucket and the vocoder's frame buckets 64 .. 512
    assert iface.counters["buckets_built"] == 1 + 8 and iface.counters["buckets_built_live"] == 0
    one = iface(TEXTS[0], input_is_phones=True)
    page = iface.read_to_file(TEXTS, tmp_path / "page.wav", input_is_phones=True)
    assert iface.counters["buckets_built_live"] == 0
    batch = iface.synthesize_batch(TEXTS, input_is_phones=True)   # a batch of 2: new buckets
    assert iface.counters["buckets_built"] == 9 + 2 and iface.counters["buckets_built_live"] == 2
    delivered = (len(one) + len(page) - 3 * SENTENCE_JOIN_SILENCE
                 + sum(len(w) for w in batch)) // SAMPLES_PER_FRAME
    # each text's frames (they follow from its durations, not from the noise)
    a, b = (len(w) // SAMPLES_PER_FRAME for w in batch)
    assert delivered == 2 * (a + b) + a
    # the vocoder runs the frame bucket of the longest row and its receptive frames
    cut = [_frame_bucket(n + iface.vocoder.receptive_frames) for n in (a, b)]
    assert max(cut) < PHONE_BUCKET * FRAMES_PER_PHONE
    assert iface.counters == dict(requests=3, sentences=5,
                                  frames_run=cut[0] + sum(cut) + 2 * max(cut),
                                  frames_delivered=delivered, buckets_built=11,
                                  buckets_built_live=2, steps_uncut=0, frames_truncated=0)
