"""Two-tower retrieval (RecSys'19-style) with an explicit EmbeddingBag.

The bag lookup is part of the system: the rows of each bag are gathered
and summed by ``segment_sum`` (bag ids as segments), so on the card each
bag is the hand-written kernel (forward) and a gather (backward), on the
host its plain version; the mean divides by the bag size.  The JAX
package's ``TwoTowerConfig.use_kernel`` (its Pallas bag against a
``jnp.take(...).mean``) is not carried over: the tensor's device picks the
path, as for the GNNs.

Shapes:
  train_batch     — in-batch + shared sampled-negative softmax
  serve_p99/bulk  — user-tower inference + dot against request items
  retrieval_cand  — one query scored against 1M candidates (one matmul
                    + top-k, never a loop)

Parameters keep the JAX package's names (``tables.<name>``,
``item_table``, ``user_mlp.<i>.w``/``.b``, ``item_mlp.<i>.*``) in a
:class:`~repro_torch.models.layers.ParamTree`, drawn from an explicit
generator on the target device (``convert.recsys_params`` carries the JAX
package's parameters across).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.csr import resolve_device
from repro_torch.kernels.segment_ops import segment_sum
from repro_torch.models import layers as L

Params = L.ParamTree


@dataclasses.dataclass(frozen=True)
class TwoTowerConfig:
    name: str = "two-tower-retrieval"
    embed_dim: int = 256
    tower_mlp: Tuple[int, ...] = (1024, 512, 256)
    # (table name, rows) — user side bags; item table separate
    user_tables: Tuple[Tuple[str, int], ...] = (
        ("user_id", 10_000_000), ("hist_items", 1_000_000),
        ("context", 100_000))
    num_items: int = 1_000_000
    multi_hot: int = 8
    num_negatives: int = 1024
    param_dtype: Any = torch.float32

    def param_count(self) -> int:
        rows = sum(r for _, r in self.user_tables) + self.num_items
        mlp = 0
        din = self.embed_dim * len(self.user_tables)
        for h in self.tower_mlp:
            mlp += din * h + h
            din = h
        din = self.embed_dim
        for h in self.tower_mlp:
            mlp += din * h + h
            din = h
        return rows * self.embed_dim + mlp


def init(cfg: TwoTowerConfig, seed: int = 0, device=None) -> Params:
    """The parameters of ``cfg`` on ``device`` (``None``: the card, see
    ``csr.resolve_device``), drawn there from ``seed`` (on ``meta``:
    shapes and dtypes, nothing drawn)."""
    device = resolve_device(device)
    if device.type == "meta":
        with torch.device("meta"):
            return _tree(cfg, torch.Generator(), device)
    return _tree(cfg, torch.Generator(device=device).manual_seed(seed),
                 device)


def abstract_params(cfg: TwoTowerConfig) -> Params:
    """The parameters of ``cfg`` on ``meta``: shapes and dtypes, no
    memory."""
    return init(cfg, device="meta")


def _tree(cfg: TwoTowerConfig, gen: torch.Generator, device) -> Params:
    pd = cfg.param_dtype

    def mlp(din):
        out = {}
        for i, h in enumerate(cfg.tower_mlp):
            out[str(i)] = {"w": L.he_init(gen, (din, h), pd).to(device),
                           "b": torch.zeros(h, dtype=pd, device=device)}
            din = h
        return out

    tree = {"tables": {
        name: L.embed_init(gen, (rows, cfg.embed_dim), pd).to(device)
        for name, rows in cfg.user_tables}}
    tree["item_table"] = L.embed_init(gen, (cfg.num_items, cfg.embed_dim),
                                      pd).to(device)
    tree["user_mlp"] = mlp(cfg.embed_dim * len(cfg.user_tables))
    tree["item_mlp"] = mlp(cfg.embed_dim)
    return L.ParamTree(tree)


def logical_axes(cfg: TwoTowerConfig) -> Dict:
    """Each parameter's logical axis names, by the parameter tree's names
    (the JAX package's table: the embedding tables row-sharded, the towers'
    hidden dims over ``mlp``)."""
    ax: Dict = {"tables": {name: ("table_rows", None)
                           for name, _ in cfg.user_tables},
                "item_table": ("table_rows", None)}
    for tower in ("user_mlp", "item_mlp"):
        ax[tower] = {str(i): {"w": (None, "mlp"), "b": ("mlp",)}
                     for i in range(len(cfg.tower_mlp))}
    return ax


def embedding_bag(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Mean-pooled bag lookup: ids [B, M] -> [B, D].  The B·M rows are
    gathered and each bag's M rows summed by ``segment_sum`` (sorted bag
    ids, one segment a bag)."""
    B, M = ids.shape
    flat = F.embedding(ids.reshape(-1).long(), table)
    bag = torch.arange(B, dtype=torch.int32,
                       device=ids.device).repeat_interleave(M)
    return (segment_sum(flat, bag, B, is_sorted=True) / M).to(table.dtype)


def _tower(mlp: Params, x: torch.Tensor) -> torch.Tensor:
    layers = [layer for _, layer in mlp.items()]
    for i, layer in enumerate(layers):
        x = x @ layer["w"] + layer["b"]
        if i < len(layers) - 1:
            x = torch.relu(x)
    # L2-normalized output embeddings (the retrieval convention)
    return x * torch.rsqrt(x.square().sum(-1, keepdim=True) + 1e-12)


def user_embedding(params: Params, feats: Dict[str, torch.Tensor],
                   cfg: TwoTowerConfig) -> torch.Tensor:
    cols = [embedding_bag(params["tables"][name], feats[name])
            for name, _ in cfg.user_tables]
    return _tower(params["user_mlp"], torch.cat(cols, -1))


def item_embedding(params: Params, item_ids: torch.Tensor,
                   cfg: TwoTowerConfig) -> torch.Tensor:
    emb = F.embedding(item_ids.long(), params["item_table"])
    return _tower(params["item_mlp"], emb)


def loss_fn(params: Params, batch: Dict[str, Any], cfg: TwoTowerConfig
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Sampled softmax: positives on the diagonal, shared negatives from
    the first ``num_negatives`` in-batch items."""
    u = user_embedding(params, batch["feats"], cfg)  # [B, D]
    it = item_embedding(params, batch["item_ids"], cfg)  # [B, D]
    temp = 20.0
    pos = (u * it).sum(-1, keepdim=True) * temp  # [B, 1]
    neg = (u @ it[:cfg.num_negatives].T) * temp  # [B, Nneg]
    # mask the accidental positive among the negatives
    n = min(cfg.num_negatives, u.shape[0])
    bidx = torch.arange(u.shape[0], device=u.device)[:, None]
    nidx = torch.arange(n, device=u.device)[None, :]
    neg = torch.where(bidx == nidx, -1e30, neg[:, :n])
    logits = torch.cat([pos, neg], -1).to(torch.float32)
    loss = (torch.logsumexp(logits, -1) - logits[:, 0]).mean()
    return loss, {"pos_score": (pos.mean() / temp).detach()}


def serve_scores(params: Params, feats: Dict[str, torch.Tensor],
                 item_ids: torch.Tensor, cfg: TwoTowerConfig
                 ) -> torch.Tensor:
    """Online/bulk inference: the score of each (user, item) pair, [B]."""
    u = user_embedding(params, feats, cfg)
    it = item_embedding(params, item_ids, cfg)
    return (u * it).sum(-1)


def retrieval_topk(params: Params, feats: Dict[str, torch.Tensor],
                   cand_ids: torch.Tensor, cfg: TwoTowerConfig,
                   k: int = 100) -> Tuple[torch.Tensor, torch.Tensor]:
    """One query against the candidates: one matmul and the top k,
    (values, positions in ``cand_ids``)."""
    u = user_embedding(params, feats, cfg)  # [1, D]
    it = item_embedding(params, cand_ids, cfg)  # [C, D]
    scores = (u @ it.T)[0]  # [C]
    return torch.topk(scores, k)
