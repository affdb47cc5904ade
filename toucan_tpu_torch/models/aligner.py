"""CTC forced aligner (mel -> phone posteriors) with MAS binarization.

Counterpart of ``toucan_tpu/models/aligner.py`` (reference
``TrainingInterfaces/Text_to_Spectrogram/AutoAligner/Aligner.py``): five
BatchNorm conv layers (ReLU *before* the norm, as the reference does), a
bidirectional LSTM of 512 and a linear layer over 145 phone classes (blank
144).  Parameter names are the reference's state-dict keys: ``convs.{2i}``
the conv layers (dropouts at the odd indices), ``rnn`` the LSTM,
``proj`` the projection.  Padded frames go through the LSTM as packed
sequences, which is what JAX's masks and its reverse-within-length flip
compute.

``train=True`` normalizes with the batch's statistics and updates the
running ones as flax does (``0.9 * old + 0.1 * batch``, with the biased
batch variance; ``nn.BatchNorm1d`` would take the unbiased one), and
dropout is on only where ``deterministic=False``, so the cloner's fine-tune
(train, deterministic) is JAX's.  The aligner runs on library kernels
(cuDNN convs and LSTM); no custom kernel is on its path, so it can train.
MAS, the DAG dijkstra and ``alignment_from_logits`` are host numpy, copied
from the JAX module; ``mas_torch`` is its on-device ``mas_jax``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

from toucan_tpu_torch.frontend.inventory import CTC_BLANK_ID, NUM_CTC_SYMBOLS

BN_MOMENTUM = 0.9   # flax's: running = 0.9 * running + 0.1 * batch
BN_EPS = 1e-5


class BatchNormConv(nn.Module):
    def __init__(self, in_channels: int, channels: int, kernel_size: int = 3):
        super().__init__()
        self.conv = nn.Conv1d(in_channels, channels, kernel_size, padding=kernel_size // 2,
                              bias=False)
        self.bnorm = nn.BatchNorm1d(channels, eps=BN_EPS)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """(B, C, T) -> (B, channels, T)."""
        x = F.relu(self.conv(x))
        bn = self.bnorm
        if not train:
            return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                                training=False, eps=BN_EPS)
        with torch.no_grad():
            mean = x.mean(dim=(0, 2))
            var = x.var(dim=(0, 2), unbiased=False)
            bn.running_mean.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * mean)
            bn.running_var.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * var)
        return F.batch_norm(x, None, None, bn.weight, bn.bias, training=True, eps=BN_EPS)


class Aligner(nn.Module):
    def __init__(self, n_mels: int = 80, num_symbols: int = NUM_CTC_SYMBOLS,
                 lstm_dim: int = 512, conv_dim: int = 512):
        super().__init__()
        layers, cin = [], n_mels
        for _ in range(5):
            layers += [BatchNormConv(cin, conv_dim, 3), nn.Dropout(0.5)]
            cin = conv_dim
        self.convs = nn.ModuleList(layers)
        self.rnn = nn.LSTM(conv_dim, lstm_dim, batch_first=True, bidirectional=True)
        self.proj = nn.Linear(2 * lstm_dim, num_symbols)

    @classmethod
    def for_state_dict(cls, sd) -> "Aligner":
        """An aligner of the widths of state dict ``sd``."""
        return cls(n_mels=sd["convs.0.conv.weight"].shape[1],
                   num_symbols=sd["proj.weight"].shape[0],
                   lstm_dim=sd["rnn.weight_hh_l0"].shape[1],
                   conv_dim=sd["convs.0.conv.weight"].shape[0])

    def forward(self, mel: torch.Tensor, lengths=None, train: bool = False,
                deterministic: bool = True) -> torch.Tensor:
        """mel (B, T, 80), true lengths (B,) or None -> logits (B, T,
        num_symbols); frames past a length give the projection's bias."""
        x = mel.transpose(1, 2)
        for conv, dropout in zip(self.convs[::2], self.convs[1::2]):
            x = F.dropout(conv(x, train), dropout.p, training=not deterministic)
        x = x.transpose(1, 2)
        if lengths is None:
            x, _ = self.rnn(x)
        else:
            lengths = torch.as_tensor(lengths).cpu()
            packed = pack_padded_sequence(x, lengths, batch_first=True, enforce_sorted=False)
            x, _ = pad_packed_sequence(self.rnn(packed)[0], batch_first=True,
                                       total_length=mel.shape[1])
        return self.proj(x)


def ctc_loss(logits, logit_lengths, labels, label_lengths, blank_id: int = CTC_BLANK_ID):
    """Mean CTC loss, as the reference's ``nn.CTCLoss(blank=144,
    zero_infinity=True)``: each sequence's loss divided by its label
    length, then the mean.  An infeasible sequence (fewer frames than its
    labels need) counts 0 here; JAX's optax loss gives it a large finite
    value instead."""
    log_probs = logits.log_softmax(-1).transpose(0, 1)  # (T, B, C)
    labels = torch.as_tensor(labels, dtype=torch.long, device=log_probs.device)
    return F.ctc_loss(log_probs, labels,
                      torch.as_tensor(logit_lengths, dtype=torch.long).cpu(),
                      torch.as_tensor(label_lengths, dtype=torch.long).cpu(),
                      blank=blank_id, reduction="mean", zero_infinity=True)


# ------------------------------------------------------------------- MAS

def mas_numpy(scores: np.ndarray) -> np.ndarray:
    """Monotonic alignment search over (frames, tokens) scores.

    Matches the reference ``binarize_alignment`` (Aligner.py:202-234)
    including its positive-shift preprocessing.
    """
    scores = np.asarray(scores, dtype=np.float64)
    scores = scores + (np.abs(scores).max() + 1.0)
    attn = np.log(scores)
    attn[0, 1:] = -np.inf
    frames, tokens = attn.shape
    log_p = np.full_like(attn, -np.inf)
    log_p[0] = attn[0]
    prev_ind = np.zeros_like(attn, dtype=np.int64)
    for i in range(1, frames):
        prev_same = log_p[i - 1]
        prev_move = np.concatenate([[-np.inf], log_p[i - 1, :-1]])
        take_move = prev_move >= prev_same
        log_p[i] = attn[i] + np.where(take_move, prev_move, prev_same)
        prev_ind[i] = np.where(take_move, np.arange(tokens) - 1, np.arange(tokens))
    opt = np.zeros((frames, tokens), dtype=np.float32)
    j = tokens - 1
    for i in range(frames - 1, -1, -1):
        opt[i, j] = 1.0
        j = prev_ind[i, j]
    opt[0, j] = 1.0
    return opt


def mas_torch(scores: torch.Tensor) -> torch.Tensor:
    """MAS on the scores' device, as ``toucan_tpu/models/aligner.py::mas_jax``:
    the same shift and log, the forward DP in float32 (-1e30 for the
    unreachable start), the backtrack; a one-hot (frames, tokens) path,
    that of ``mas_numpy``."""
    scores = scores.float()
    attn = torch.log(scores + (scores.abs().max() + 1.0))
    frames, tokens = attn.shape
    cols = torch.arange(tokens, device=attn.device)
    neg_inf = torch.full((1,), -1e30, device=attn.device)
    log_p = torch.where(cols == 0, attn[0], neg_inf)
    prev = torch.zeros((frames, tokens), dtype=torch.long, device=attn.device)
    for i in range(1, frames):
        prev_move = torch.cat([neg_inf, log_p[:-1]])
        take_move = prev_move >= log_p
        log_p = attn[i] + torch.where(take_move, prev_move, log_p)
        prev[i] = torch.where(take_move, cols - 1, cols)
    path = torch.empty(frames, dtype=torch.long, device=attn.device)
    j = torch.tensor(tokens - 1, device=attn.device)
    for i in range(frames - 1, -1, -1):
        path[i] = j
        j = prev[i, j]
    return F.one_hot(path, tokens).float()


# -------------------------------------------------------------- dijkstra

def dijkstra_numpy(path_probs: np.ndarray) -> np.ndarray:
    """Shortest monotone path through the (frames, tokens) cost grid.

    Equivalent to the reference's alternative pathfinding
    (``Aligner.py:141-199,245-280``): a sparse graph over grid nodes with
    right / down / down-right moves, each edge weighted by the cost of the
    *target* cell, solved with scipy's Dijkstra from node (0, 0) to
    (frames-1, tokens-1); a frame visited multiple times (right moves) keeps
    the last token on the path.  The grid graph is a DAG in node order, so
    instead of materializing an O((T*N)^2) sparse matrix we run an exact
    per-row DP: vertical candidates come from row i-1, and the within-row
    right-move recurrence ``d[j] = min(v[j], d[j-1] + c[j])`` collapses to a
    running minimum of ``v - cumsum(c)`` (also correct for negative edge
    weights, where Dijkstra's greedy assumption breaks).

    Returns a (frames, tokens) binary path matrix with one 1 per frame.
    """
    costs = np.asarray(path_probs, dtype=np.float64)
    frames, cols = costs.shape
    dist = np.empty((frames, cols))
    # entry[i, j] = where (i, j) was entered from: own-row right move (the
    # column it descended from row i-1 at) vs vertical; sign marks diag.
    from_col = np.empty((frames, cols), dtype=np.int64)   # source column k<=j
    vert_diag = np.zeros((frames, cols), dtype=bool)      # True: (i-1,k-1)

    # row 0: only right moves from (0, 0); node (0, 0) itself costs nothing
    row_cum = np.cumsum(costs[0])
    dist[0] = row_cum - costs[0, 0]
    dist[0, 0] = 0.0
    from_col[0] = 0

    for i in range(1, frames):
        # vertical entry at column k: best of down (i-1, k) and diag (i-1, k-1)
        down = dist[i - 1] + costs[i]
        diag = np.concatenate([[np.inf], dist[i - 1, :-1]]) + costs[i]
        use_diag = diag < down
        vert = np.where(use_diag, diag, down)
        # within-row right moves: d[j] = min_{k<=j} vert[k] + (cum[j] - cum[k])
        cum = np.cumsum(costs[i])
        key = vert - cum
        run_min = np.minimum.accumulate(key)
        # argmin of the running minimum (first occurrence, ties -> smallest k)
        is_new_min = key == run_min
        k_star = np.maximum.accumulate(np.where(is_new_min, np.arange(cols), -1))
        dist[i] = run_min + cum
        from_col[i] = k_star
        vert_diag[i] = use_diag

    # backtrack from (frames-1, cols-1)
    path_plot = np.zeros((frames, cols), dtype=np.float32)
    i, j = frames - 1, cols - 1
    while True:
        k = from_col[i, j]
        path_plot[i, j] = 1.0  # last token per frame wins (mel_text overwrite)
        if i == 0:
            break
        # frame i was entered vertically at column k; frames only record the
        # final (largest) column, which is j — already set above
        j = k - 1 if vert_diag[i, k] else k
        i -= 1
    return path_plot


def alignment_from_logits(logits: np.ndarray, token_ids: np.ndarray,
                          method: str = "MAS") -> np.ndarray:
    """(T, num_symbols) logits + token id sequence -> (T, N) binary alignment
    on the token columns (reference: ``Aligner.inference`` with
    ``pathfinding="MAS"`` or ``"dijkstra"``)."""
    pred_max = np.asarray(logits)[:, np.asarray(token_ids)]
    if method.lower() == "dijkstra":
        return dijkstra_numpy(1.0 - pred_max)
    return mas_numpy(pred_max)


def path_score(pred_max: np.ndarray, alignment: np.ndarray, method: str = "MAS") -> float:
    """What ``alignment_from_logits``'s pathfinding maximizes, for the path
    in ``alignment`` (frames, tokens; one token a frame) under ``pred_max``
    (the logits of the transcript's tokens): for MAS the sum, over the
    path's cells, of the log of the scores shifted positive; for dijkstra
    minus the cost (1 - score) of every cell the path visits (a frame that
    moves on by several tokens visits each, and enters from the previous
    frame's token or diagonally, whichever costs less).  Not in the JAX
    package: it tells how near two alignments of close logits come to a
    tie."""
    p = np.asarray(pred_max, np.float64)
    col = np.asarray(alignment).argmax(1)
    if method.lower() != "dijkstra":
        return float(np.log(p + (np.abs(p).max() + 1.0))[np.arange(len(col)), col].sum())
    cost = 1.0 - p
    total = cost[0, 1:col[0] + 1].sum()
    for i in range(1, len(col)):
        a, b = col[i - 1], col[i]
        total += cost[i, b] if a == b else cost[i, a + 1:b + 1].sum() + min(0.0, cost[i, a])
    return -float(total)
