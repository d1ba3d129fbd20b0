"""BiLSTM prosody regressor, in PyTorch (parity with
Code/baseline_models/bilstm.py:116-135):

    LayerNorm → BiLSTM(40) → tanh Dense(20) → Dense(3)   [pitch, volume, rate]

float32 throughout. Inputs are sliding windows of SEQ_LEN ∈ {1..4} sentence
embeddings (bilstm.py:62-95); targets are z-scored percentages
(load_and_calibrate, :28-60). The flax model runs a forward cell and a
second cell over the reversed sequence, and reads both at the last
position: for the reversed half that is its output after one step, over
the last element alone. ``nn.LSTM(bidirectional=True)`` gives the same as
``out[:, -1, H:]`` (not ``h_n``, which is the reversed half's last step).
flax's LSTM cell has no input bias, so ``bias_ih`` stays zero and is not
trained; its gate order i, f, g, o is ``nn.LSTM``'s.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..ops.kernels import dsp_precision, resolve_device
from .bert import LayerNorm, lecun_normal


@dataclass(frozen=True)
class BiLSTMConfig:
    embed_dim: int = 768  # all-mpnet-base-v2 dimension (bilstm.py:12)
    hidden: int = 40  # bilstm.py:121
    dense: int = 20  # bilstm.py:128
    outputs: int = 3  # pitch, volume, rate


class BiLSTMProsody(nn.Module):
    """x [B, T, embed_dim] windows of sentence embeddings → [B, outputs].
    Parameters are initialised as flax initialises them (lecun-normal input
    and dense kernels, orthogonal recurrent kernels, zero biases), drawn on
    the CPU from ``seed`` (``seed=None`` leaves them for a
    ``load_state_dict``), then moved to ``device``."""

    def __init__(self, cfg: BiLSTMConfig = BiLSTMConfig(), seed: int | None = 0, device="cuda"):
        dev = resolve_device(device)
        super().__init__()
        self.cfg = cfg
        self.norm = LayerNorm(cfg.embed_dim)
        self.lstm = nn.LSTM(cfg.embed_dim, cfg.hidden, batch_first=True, bidirectional=True)
        for name in ("bias_ih_l0", "bias_ih_l0_reverse"):
            getattr(self.lstm, name).requires_grad_(False)
        self.dense = nn.Linear(2 * cfg.hidden, cfg.dense)
        self.out = nn.Linear(cfg.dense, cfg.outputs)
        if seed is not None:
            self._init(seed)
        if dev.type == "cuda":
            dsp_precision()
        self.to(dev)

    def _init(self, seed: int) -> None:
        g = torch.Generator().manual_seed(seed)
        H = self.cfg.hidden

        def lecun(shape_in_out):
            return lecun_normal(shape_in_out[0], shape_in_out, g)

        def orthogonal(n):
            q, r = torch.linalg.qr(torch.randn(n, n, generator=g))
            return q * torch.sign(torch.diagonal(r))

        with torch.no_grad():
            self.norm.scale.fill_(1.0)
            self.norm.bias.zero_()
            for sfx in ("", "_reverse"):
                # per gate, [in, H] kernels as flax holds them; nn.LSTM stacks [4H, in]
                w_ih = torch.cat([lecun((self.cfg.embed_dim, H)).T for _ in range(4)])
                w_hh = torch.cat([orthogonal(H).T for _ in range(4)])
                getattr(self.lstm, f"weight_ih_l0{sfx}").copy_(w_ih)
                getattr(self.lstm, f"weight_hh_l0{sfx}").copy_(w_hh)
                getattr(self.lstm, f"bias_ih_l0{sfx}").zero_()
                getattr(self.lstm, f"bias_hh_l0{sfx}").zero_()
            for lin in (self.dense, self.out):
                lin.weight.copy_(lecun((lin.in_features, lin.out_features)).T)
                lin.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        H = self.cfg.hidden
        ys, _ = self.lstm(self.norm(x))
        h = torch.cat([ys[:, -1, :H], ys[:, -1, H:]], -1)  # both halves at the last position
        return self.out(torch.tanh(self.dense(h)))


def init_bilstm(cfg: BiLSTMConfig, seed: int, device) -> BiLSTMProsody:
    """The regressor ``train_bilstm`` starts from (tests replace it with the
    JAX package's initialisation, converted)."""
    return BiLSTMProsody(cfg, seed=seed, device=device)


def sliding_windows(embeddings: np.ndarray, targets: np.ndarray, seq_len: int):
    """[N, D], [N, 3] → ([N-L+1, L, D], [N-L+1, 3]) — window predicts the
    last element's targets (bilstm.py:62-95)."""
    n = embeddings.shape[0]
    if n < seq_len:
        return np.zeros((0, seq_len, embeddings.shape[1])), np.zeros((0, targets.shape[1]))
    xs = np.stack([embeddings[i : i + seq_len] for i in range(n - seq_len + 1)])
    ys = targets[seq_len - 1 :]
    return xs, ys


def zscore_calibrate(values: np.ndarray):
    """(values−μ)/σ plus the inverse transform — the raw-%↔z-score
    calibration the reference reports both ways (bilstm.py:28-60,247-271)."""
    mu = values.mean(axis=0)
    sd = values.std(axis=0)
    sd = np.where(sd < 1e-8, 1.0, sd)
    return (values - mu) / sd, (mu, sd)


def train_bilstm(
    xs: np.ndarray,
    ys: np.ndarray,
    *,
    seed: int = 0,
    epochs: int = 60,
    batch_size: int = 32,
    lr: float = 1e-3,
    val_frac: float = 0.15,
    device="cuda",
):
    """MSE/Adam training with the best-validation parameters kept
    (bilstm.py:184-232). The split and the batch order come from
    ``np.random.default_rng(seed)`` as in the JAX package. Returns
    (state_dict, history); one host read of the validation loss an epoch."""
    dev = resolve_device(device)
    model = init_bilstm(BiLSTMConfig(embed_dim=xs.shape[-1]), seed, dev)
    opt = torch.optim.Adam([p for p in model.parameters() if p.requires_grad], lr=lr, betas=(0.9, 0.999), eps=1e-8)

    n = xs.shape[0]
    n_val = max(1, int(n * val_frac))
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    val_idx, tr_idx = perm[:n_val], perm[n_val:]
    xs_d = torch.as_tensor(np.asarray(xs, np.float32), device=dev)
    ys_d = torch.as_tensor(np.asarray(ys, np.float32), device=dev)
    xv, yv = xs_d[torch.as_tensor(val_idx, device=dev)], ys_d[torch.as_tensor(val_idx, device=dev)]

    best = (np.inf, {k: v.detach().clone() for k, v in model.state_dict().items()})
    history = []
    for _ in range(epochs):
        rng.shuffle(tr_idx)
        for i in range(0, len(tr_idx), batch_size):
            b = torch.as_tensor(tr_idx[i : i + batch_size], device=dev)
            loss = torch.mean((model(xs_d[b]) - ys_d[b]) ** 2)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
        with torch.no_grad():
            vl = float(torch.mean((model(xv) - yv) ** 2))
        history.append(vl)
        if vl < best[0]:
            best = (vl, {k: v.detach().clone() for k, v in model.state_dict().items()})
    return best[1], history
