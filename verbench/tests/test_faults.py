"""Each fault a cell can have, planted under a tiny CPU run, makes
``correct`` come out false (the harness's look for a chip skipped)."""

import torch

import vln_ver_tpu_torch.get_occ as get_occ
import vln_ver_tpu_torch.train.step as step
from verbench.driver import Driver
from vln_ver_tpu_torch.models.detector import VoxelFormer

from . import tiny


def test_full_answer_altered(monkeypatch):
    forward = VoxelFormer.forward

    def altered(self, *a, **k):
        out = dict(forward(self, *a, **k))
        occ = out["occupancy_preds"].clone()
        occ[0] += 0.2 * occ[0].std()
        out["occupancy_preds"] = occ
        return out
    monkeypatch.setattr(VoxelFormer, "forward", altered)
    out = tiny.run("ver36-full-b8")
    assert not out["correct"]


def test_dump_volume_altered(monkeypatch):
    make = get_occ.make_bev_only

    def altered(model, vit=None):
        inner = make(model, vit)

        def bev_only(*a):
            bev, ovf = inner(*a)
            return bev + 0.2 * bev.std(), ovf
        return bev_only
    monkeypatch.setattr(get_occ, "make_bev_only", altered)
    assert not tiny.run("ver36-dump-b8")["correct"]


def test_train_state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, *a: None)
    out = tiny.run("vocc-train-b1")
    assert not out["correct"]
    assert out["checks"]["change"]["value"] > 0.99


def from_the_window(monkeypatch, plant):
    """Plant a fault when the window starts, after set-up's steps."""
    start = Driver.start_window

    def start_then_fault(self):
        plant(self)
        return start(self)
    monkeypatch.setattr(Driver, "start_window", start_then_fault)


def test_train_window_state_unchanged(monkeypatch):
    from_the_window(monkeypatch, lambda d: monkeypatch.setattr(
        torch.optim.AdamW, "step", lambda self, *a, **k: None))
    out = tiny.run("vocc-train-b1")
    assert not out["correct"]
    assert out["checks"]["loss"]["value"] <= out["checks"]["loss"]["limit"]


def test_train_loss_altered(monkeypatch):
    losses = step.compute_losses

    def altered(*a, **k):
        d = losses(*a, **k)
        d["loss_occupancy"] = d["loss_occupancy"] * 1.05
        return d
    monkeypatch.setattr(step, "compute_losses", altered)
    assert not tiny.run("vocc-train-b1")["correct"]
