"""Full-precision baseline retrieval model (port of
atq_tpu/models/baseline_retrieval.py), the teacher of ``--train_baseline``
and ``--distill``.

ResNet-18 features -> Linear/GELU/LayerNorm/Linear projector; token
embedding (N(0, 0.02)) -> a bidirectional GRU whose forward state at each
sequence's last token and backward state at its first token are
concatenated -> the same projector; both embeddings L2-normalized; a
learnable temperature (0.07).

The GRU is flax's ``GRUCell`` (gates ``ir``/``iz``/``in`` from the input
with biases, ``hr``/``hz`` from the state without, ``hn`` with one;
``h' = (1 − z)·n + z·h``), run over the padded length: the forward pass
reads position ``length − 1``; the backward pass runs over each sequence's
first ``length`` tokens reversed (then the padding), as flax's ``nn.RNN``
with ``reverse=True`` and ``seq_lengths`` does. Module names are the flax
ones (``image_projector/Dense_0``, ``gru_fwd/cell/ir``, ...), so the JAX
checkpoint layout maps onto the state dict (utils/jax_interop.py).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from atq_tpu_torch.models.fusion import l2_normalize
from atq_tpu_torch.models.image_classifier import _dense
from atq_tpu_torch.models.resnet import BasicBlock, ResNetFeatures
from atq_tpu_torch.nn.initializers import normal_std_
from atq_tpu_torch.utils.platform import resolve_device


class _Projector(nn.Module):
    def __init__(self, in_features: int, embed_dim: int, generator):
        super().__init__()
        self.Dense_0 = _dense(in_features, embed_dim, generator)
        self.LayerNorm_0 = nn.LayerNorm(embed_dim, eps=1e-5)
        self.Dense_1 = _dense(embed_dim, embed_dim, generator)

    def forward(self, x):
        return self.Dense_1(self.LayerNorm_0(F.gelu(self.Dense_0(x))))


def _recurrent(hidden: int, bias: bool, generator) -> nn.Linear:
    """flax ``Dense`` of the GRU state: orthogonal kernel, zero bias."""
    layer = nn.Linear(hidden, hidden, bias=bias, device="meta").to_empty(
        device="cpu")
    nn.init.orthogonal_(layer.weight.data, generator=generator)
    if bias:
        nn.init.zeros_(layer.bias.data)
    return layer


class _GRUCell(nn.Module):
    def __init__(self, in_features: int, hidden: int, generator):
        super().__init__()
        for name in ("ir", "iz", "in"):
            setattr(self, name, _dense(in_features, hidden, generator))
        self.hr = _recurrent(hidden, False, generator)
        self.hz = _recurrent(hidden, False, generator)
        self.hn = _recurrent(hidden, True, generator)


class _GRU(nn.Module):
    """flax ``nn.RNN(GRUCell)``: ``cell`` run over (B, L, D) from a zero
    state; returns every step's state (B, L, H)."""

    def __init__(self, in_features: int, hidden: int, generator):
        super().__init__()
        self.hidden = hidden
        self.cell = _GRUCell(in_features, hidden, generator)

    def forward(self, x):
        c = self.cell
        # The input gates of every step in one product each.
        xr, xz, xn = (getattr(c, name)(x) for name in ("ir", "iz", "in"))
        h = x.new_zeros(x.shape[0], self.hidden)
        states = []
        for t in range(x.shape[1]):
            r = torch.sigmoid(xr[:, t] + c.hr(h))
            z = torch.sigmoid(xz[:, t] + c.hz(h))
            n = torch.tanh(xn[:, t] + r * c.hn(h))
            h = (1.0 - z) * n + z * h
            states.append(h)
        return torch.stack(states, dim=1)


class BaselineRetrievalModel(nn.Module):
    """Built in eval mode on ``device`` (the GPU unless the caller asks for
    the CPU). ``forward(..., train=True)`` puts BatchNorm in training mode,
    as flax's ``train`` flag does."""

    def __init__(self, vocab_size: int, embed_dim: int = 192,
                 hidden_dim: int = 384, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.image_encoder = ResNetFeatures((2, 2, 2, 2), BasicBlock,
                                            device="cpu", generator=generator)
        self.image_projector = _Projector(512, embed_dim, generator)
        self.embedding = nn.Embedding(vocab_size, embed_dim)
        normal_std_(self.embedding.weight, 0.02, generator=generator)
        self.gru_fwd = _GRU(embed_dim, hidden_dim, generator)
        self.gru_bwd = _GRU(embed_dim, hidden_dim, generator)
        self.text_projector = _Projector(2 * hidden_dim, embed_dim,
                                         generator)
        self.temperature = nn.Parameter(torch.tensor(0.07))
        self.to(resolve_device(device))
        self.eval()

    def encode_image(self, image):
        return l2_normalize(self.image_projector(self.image_encoder(image)))

    def encode_text(self, text, text_lengths=None):
        embedded = self.embedding(text)                    # (B, L, D)
        batch, seq_len = text.shape
        if text_lengths is None:
            text_lengths = torch.full((batch,), seq_len, device=text.device)
        lengths = torch.clamp(torch.as_tensor(text_lengths,
                                              device=text.device), 1, seq_len)
        last = (lengths - 1)[:, None]
        fwd = self.gru_fwd(embedded)
        # Each sequence's first `length` tokens reversed, the padding after.
        t = torch.arange(seq_len, device=text.device)[None, :]
        rev = torch.where(t < lengths[:, None], last - t, t)
        bwd = self.gru_bwd(torch.gather(
            embedded, 1, rev[:, :, None].expand(-1, -1, embedded.shape[2])))

        def at_last(states):
            return torch.gather(states, 1, last[:, :, None].expand(
                -1, 1, states.shape[2]))[:, 0]

        hidden = torch.cat([at_last(fwd), at_last(bwd)], dim=1)
        return l2_normalize(self.text_projector(hidden))

    def forward(self, image, text, text_lengths=None,
                return_embeddings: bool = False, train: bool = False):
        if self.training != train:
            self.train(train)
        image_embeddings = self.encode_image(image)
        text_embeddings = self.encode_text(text, text_lengths)
        if return_embeddings:
            return image_embeddings, text_embeddings
        return torch.matmul(image_embeddings,
                            text_embeddings.T) / self.temperature
