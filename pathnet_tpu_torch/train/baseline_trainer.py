"""Full-batch trainer for the baseline zoo (port of ``pathnet_tpu/train/baseline_trainer.py``).

The best-on-validation protocol of the PAGG trainer with a transductive
forward (no path sampling). Each epoch takes one Adam step (additive L2,
:func:`~.trainer.make_optimizer`) on the mean cross-entropy of the train
rows in train mode (dropout, batch statistics, the running statistics
advanced), then evaluates in eval mode (running statistics) and keeps the
test confusion matrix of the best validation accuracy with ``torch.where``
on a strict improvement, on the device: the round reads its result on the
host once, at its end, as JAX's scan does. Dropout masks come from one
generator per (round seed, epoch, call) (``rng.make_generator`` with stream
``STREAM_DROPOUT``). LP is one parameterless forward on the masked one-hot
train labels.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..config import TrainConfig
from ..models.baselines.zoo import Baseline, BaselineSpec, build_baseline_graphs
from ..nn.metrics import classification_metrics, confusion_matrix
from ..rng import STREAM_DROPOUT, STREAM_INIT, make_generator
from .trainer import RoundResult, make_optimizer


def _accuracy(cm: torch.Tensor) -> torch.Tensor:
    return cm.diagonal().sum() / cm.sum().clamp(min=1.0)


def dropout_masks(seed: int, epoch: int, keep: float):
    """Keep masks for one epoch's training forward: call ``i`` draws from
    its own generator, keyed by (round seed, epoch, ``i``)."""
    def mask(i: int, shape: tuple, device: torch.device) -> torch.Tensor:
        gen = make_generator(seed, epoch, STREAM_DROPOUT, i, device=device)
        return torch.rand(shape, generator=gen, device=device) < keep
    return mask


def run_baseline_round(g, spec: BaselineSpec, cfg: TrainConfig, train_mask: np.ndarray,
                       val_mask: np.ndarray, test_mask: np.ndarray, num_classes: int,
                       seed: int = 0, device=None, track_history: bool = False
                       ) -> RoundResult:
    """One baseline round on ``device`` (None: the CUDA card) from a host
    ``Graph`` with features and labels: init from the seed, ``cfg.epochs``
    epochs, the test metrics of the best-on-validation epoch. With
    ``track_history`` the result carries each epoch's validation accuracy
    and train loss (kept on the device until the round ends)."""
    from ..device import resolve_device

    spec.check_ported()
    dev = resolve_device(device)
    graphs = build_baseline_graphs(g, spec.name, dev)
    X = torch.from_numpy(np.array(g.features, np.float32)).to(dev)
    y = torch.from_numpy(np.array(g.labels, np.int64)).to(dev)
    tr, va, te = (torch.from_numpy(np.flatnonzero(m)).to(dev)
                  for m in (train_mask, val_mask, test_mask))
    model = Baseline(spec, device=dev, generator=make_generator(seed, 0, STREAM_INIT))
    hist, losses = [], []
    if spec.name == "lp":
        # MultiLP is parameterless: its "features" are the masked one-hot
        # train labels and one forward is the whole model
        X = (F.one_hot(y.clamp(min=0), num_classes).float()
             * torch.from_numpy(np.asarray(train_mask, np.float32)).to(dev)[:, None])
        with torch.no_grad():
            pred = model(X, graphs).argmax(-1)
        best_val = _accuracy(confusion_matrix(y[va], pred[va], num_classes))
        best_cm = confusion_matrix(y[te], pred[te], num_classes)
    else:
        opt = make_optimizer(model.parameters(), cfg.lr, cfg.weight_decay)
        best_val = torch.zeros((), device=dev)
        best_cm = torch.zeros((num_classes, num_classes), device=dev)
        keep = 1.0 - spec.dropout
        for epoch in range(cfg.epochs):
            opt.zero_grad(set_to_none=True)
            logits = model(X, graphs, train=True, masks=dropout_masks(seed, epoch, keep))
            loss = F.cross_entropy(logits.index_select(0, tr), y.index_select(0, tr))
            loss.backward()
            opt.step()
            with torch.no_grad():
                pred = model(X, graphs).argmax(-1)
                val_acc = _accuracy(confusion_matrix(y[va], pred[va], num_classes))
                best_cm = torch.where(val_acc > best_val,
                                      confusion_matrix(y[te], pred[te], num_classes), best_cm)
                best_val = torch.maximum(best_val, val_acc)
            if track_history:
                hist.append(val_acc)
                losses.append(loss.detach())
    metrics = {k: float(v) for k, v in classification_metrics(best_cm).items()}
    res = RoundResult(best_val_acc=float(best_val), metrics=metrics)
    if track_history and hist:
        res.history = torch.stack(hist).cpu().numpy()
        res.losses = torch.stack(losses).cpu().numpy()
    return res
