"""A run whose timed path is broken underneath comes out not correct:
the harness on the CPU, the program patched to make one fault at a
time, the look for a card skipped.  Faults a decode can have:
  state     a frame step that returns its state unchanged (the batched
            scan's carry; the single-stream Decoder's overlap);
  answer    an answer altered where it is produced (the third frame of
            every stream's int16 PCM returned as silence);
  half      half of the batch left out (its streams given the first
            half's PCM).
A one-card decode has no exchange between chips to leave out."""
import pytest
import torch

import heaac_tpu_torch
from heaac_tpu_torch.codec import decoder as single
from heaac_tpu_torch.codec import heaac_graph
from hebench.tests._cpu import run_cell


def test_sound_runs_are_correct(capsys):
    assert run_cell(capsys, "v2_batch_512")["correct"] is True
    line = run_cell(capsys, "v1s_stream_b1")
    assert line["correct"] is True
    assert set(line["metrics"]) == {"frame_p95_ms", "setup_s"}
    line = run_cell(capsys, "v1s_batch_256")
    assert line["correct"] is True
    assert set(line["metrics"]) == {"realtime_x", "setup_s"}


def _state_batch(monkeypatch):
    real = heaac_graph.heaac_frame_qwire

    def step(*a, **k):
        out, _ = real(*a, **k)
        return out, a[3]                 # the carry it was given
    monkeypatch.setattr(heaac_graph, "heaac_frame_qwire", step)


def _state_single(monkeypatch):
    real = single.core_frame

    def core(coeffs, saved, *a):
        out, _ = real(coeffs, saved, *a)
        return out, saved
    monkeypatch.setattr(single, "core_frame", core)


def _answer_batch(monkeypatch):
    real = heaac_tpu_torch.decode_batch

    def decode(streams, device):
        outs = real(streams, device=device)
        for o in outs:
            o[2 * 2048:3 * 2048] = 0
        return outs
    monkeypatch.setattr(heaac_tpu_torch, "decode_batch", decode)


def _answer_single(monkeypatch):
    real = single.Decoder.decode_frame

    def decode_frame(self, packet):
        pcm = real(self, packet)
        self.fault_frames = getattr(self, "fault_frames", 0) + 1
        if self.fault_frames == 3:
            pcm.zero_()
        return pcm
    monkeypatch.setattr(single.Decoder, "decode_frame", decode_frame)


def _half_batch(monkeypatch):
    real = heaac_tpu_torch.decode_batch

    def decode(streams, device):
        h = len(streams) // 2
        outs = real(streams[:h], device=device)
        return outs + [o.clone() for o in outs][:len(streams) - h]
    monkeypatch.setattr(heaac_tpu_torch, "decode_batch", decode)


@pytest.mark.parametrize("cell,fault", [
    ("v2_batch_512", _state_batch), ("v2_batch_512", _answer_batch),
    ("v2_batch_512", _half_batch), ("v1s_stream_b1", _state_single),
    ("v1s_stream_b1", _answer_single), ("v1s_batch_256", _state_batch),
    ("v1s_batch_256", _answer_batch), ("v1s_batch_256", _half_batch)],
    ids=["batch-state", "batch-answer", "batch-half", "single-state",
         "single-answer", "stereo-batch-state", "stereo-batch-answer",
         "stereo-batch-half"])
def test_fault_is_not_correct(cell, fault, monkeypatch, capsys):
    torch.manual_seed(0)
    fault(monkeypatch)
    line = run_cell(capsys, cell)
    assert line["correct"] is False, line["checks"]
