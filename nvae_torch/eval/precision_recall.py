"""k-NN precision/recall (Kynkäänniemi et al.) on one device (counterpart
of ``nvae_tpu/eval/precision_recall.py``).

Each distribution's manifold is the union of hyperspheres around its
samples, each with the distance to the sample's k-th nearest neighbour as
radius; precision is the share of generated samples inside the real
manifold and recall the share of real samples inside the generated one.

Every pass is bounded in memory: below ``row_batch_size`` rows a pass takes
the full distance matrix; above it, rows go in blocks of ``row_batch_size``
and columns stream in blocks of ``min(row_batch_size, N)`` (the last block
may be shorter), with a running top-(k+1) merge for the radii and an OR for
membership, so a tile is at most ``row_batch_size`` squared.  The distance
products run in full fp32 (``fp32_math``: no TF32 on the card), as the JAX
package runs them at ``Precision.HIGHEST``: a sample near a sphere's
boundary needs it.

``mesh=`` (``parallel.mesh.DataMesh``) splits the rows of every pass over
the ranks, as JAX's ``mesh=`` shards them: each rank finds the radii, the
membership and the realism of its block of rows against all columns, and
the ranks gather the blocks (``DataMesh.map_rows``), so each row's numbers
are those of the single-device pass and every rank holds the result.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from nvae_torch.device import DeviceLike, fp32_math, resolve_device


def _as_features(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def pairwise_sq_dists(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(N, D), (M, D) -> (N, M) squared Euclidean distances, clamped >= 0."""
    norm_u = torch.sum(u * u, dim=1)[:, None]
    norm_v = torch.sum(v * v, dim=1)[None, :]
    with fp32_math():
        cross = u @ v.T
    return torch.clamp(norm_u - 2.0 * cross + norm_v, min=0.0)


def _knn_radii(features: torch.Tensor, k: int,
               rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Distance of each of ``rows`` (samples of ``features``, by default
    all of them) to its k-th nearest other sample, from the full distance
    matrix (the k+1 smallest include the sample itself, at 0)."""
    d = pairwise_sq_dists(features if rows is None else rows, features)
    return torch.topk(d, k + 1, dim=1, largest=False).values[:, k]


def _knn_radii_rows(rows: torch.Tensor, features: torch.Tensor, k: int,
                    col_batch: int) -> torch.Tensor:
    """k-NN radii of ``rows`` against all of ``features``, streaming column
    blocks: a running buffer of the k+1 smallest distances is merged with
    each (R, col_batch) tile."""
    best = torch.full((rows.shape[0], k + 1), float("inf"),
                      device=rows.device)
    for j in range(0, features.shape[0], col_batch):
        d = pairwise_sq_dists(rows, features[j:j + col_batch])
        best = torch.topk(torch.cat([best, d], dim=1), k + 1, dim=1,
                          largest=False).values
    return best[:, k]


def _knn_radii_batched(features: torch.Tensor, k: int, row_batch_size: int,
                       rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Row blocks of ``_knn_radii_rows`` (of ``rows``, by default every
    sample): O(row_batch^2) memory at any N."""
    rows = features if rows is None else rows
    col_batch = min(row_batch_size, features.shape[0])
    return torch.cat([
        _knn_radii_rows(rows[i:i + row_batch_size], features, k, col_batch)
        for i in range(0, rows.shape[0], row_batch_size)])


def _over_rows(mesh, x: torch.Tensor, fn):
    """``fn(x)``, or with a mesh its rows split over the ranks."""
    return fn(x) if mesh is None else mesh.map_rows(x, fn)


def _radii_for(features: torch.Tensor, k: int, row_batch_size: int,
               mesh=None) -> torch.Tensor:
    if features.shape[0] > row_batch_size:
        def radii(rows):
            return _knn_radii_batched(features, k, row_batch_size, rows)
    else:
        def radii(rows):
            return _knn_radii(features, k, rows)
    return _over_rows(mesh, features, radii)


def _membership(eval_feats: torch.Tensor, ref_feats: torch.Tensor,
                radii: torch.Tensor) -> torch.Tensor:
    """(E,) bool: does each eval sample fall inside any reference sphere?"""
    d = pairwise_sq_dists(eval_feats, ref_feats)
    return torch.any(d <= radii[None, :], dim=1)


def _membership_rows(rows: torch.Tensor, ref_feats: torch.Tensor,
                     radii: torch.Tensor, col_batch: int) -> torch.Tensor:
    """Column-streamed membership: OR over (R, col_batch) tiles."""
    inside = torch.zeros(rows.shape[0], dtype=torch.bool, device=rows.device)
    for j in range(0, ref_feats.shape[0], col_batch):
        inside |= _membership(rows, ref_feats[j:j + col_batch],
                              radii[j:j + col_batch])
    return inside


def _batched_membership(eval_feats: torch.Tensor, ref_feats: torch.Tensor,
                        radii: torch.Tensor,
                        row_batch_size: int) -> torch.Tensor:
    """Membership of every eval row, in row blocks, with the reference
    side streamed in column blocks above ``row_batch_size`` rows."""
    nb = ref_feats.shape[0]
    col_batch = min(row_batch_size, nb)
    hits = []
    for i in range(0, eval_feats.shape[0], row_batch_size):
        rows = eval_feats[i:i + row_batch_size]
        hits.append(_membership_rows(rows, ref_feats, radii, col_batch)
                    if nb > row_batch_size
                    else _membership(rows, ref_feats, radii))
    return torch.cat(hits)


def _evaluate_rows(rows: torch.Tensor, ref_feats: torch.Tensor,
                   radii_mat: torch.Tensor, col_batch: int, eps: float):
    """One distance tile per column block feeds membership for every
    neighbourhood size, the realism score (from the first size's radii)
    and the nearest reference index; ties go to the earlier block, and
    within a block to the first column, as ``np.argmin`` does.  Returns
    (inside (R, K) bool, realism (R,), neighbour index (R,) int32)."""
    r_n = rows.shape[0]
    dev = rows.device
    inside = torch.zeros(r_n, radii_mat.shape[1], dtype=torch.bool,
                         device=dev)
    best_real = torch.full((r_n,), float("-inf"), device=dev)
    best_d = torch.full((r_n,), float("inf"), device=dev)
    best_idx = torch.zeros(r_n, dtype=torch.int32, device=dev)
    for off in range(0, ref_feats.shape[0], col_batch):
        r = radii_mat[off:off + col_batch]
        d = pairwise_sq_dists(rows, ref_feats[off:off + col_batch])
        inside |= torch.any(d[:, :, None] <= r[None, :, :], dim=1)
        best_real = torch.maximum(
            best_real, torch.max(r[None, :, 0] / (d + eps), dim=1).values)
        d_loc, i_loc = torch.min(d, dim=1)
        take = d_loc < best_d  # strict: the earlier block wins a tie
        best_d = torch.where(take, d_loc, best_d)
        best_idx = torch.where(take, (off + i_loc).to(torch.int32), best_idx)
    return inside, best_real, best_idx


class ManifoldEstimator:
    """The manifold of a feature set as k-NN hyperspheres, one set of
    radii per neighbourhood size, with the reference's full ``evaluate``
    surface: membership, realism, nearest neighbours, and the
    ``clamp_to_percentile`` prune (radii above that percentile, linearly
    interpolated, are set to 0).  Runs on ``device`` (the card unless the
    caller asks for the CPU), each pass's rows split over the ranks of
    ``mesh`` when one is given."""

    def __init__(
        self,
        features,
        nhood_sizes: Sequence[int] = (3,),
        row_batch_size: int = 10000,
        clamp_to_percentile: Optional[float] = None,
        eps: float = 1e-5,
        device: DeviceLike = "cuda",
        mesh=None,
    ):
        self.device = resolve_device(device)
        self.mesh = mesh
        feats = _as_features(features, self.device)
        self.nhood_sizes = tuple(int(k) for k in nhood_sizes)
        self.row_batch_size = int(row_batch_size)
        self.eps = float(eps)
        self._features = feats
        self.radii: Dict[int, torch.Tensor] = {
            k: _radii_for(feats, k, self.row_batch_size, mesh)
            for k in self.nhood_sizes
        }
        if clamp_to_percentile is not None:
            for k in self.nhood_sizes:
                r = self.radii[k]
                cutoff = torch.quantile(r, clamp_to_percentile / 100.0)
                self.radii[k] = torch.where(r > cutoff, 0.0, r)

    def membership(self, eval_features, k: int) -> torch.Tensor:
        """(E,) bool membership for one neighbourhood size."""
        ev = _as_features(eval_features, self.device)
        return _over_rows(self.mesh, ev, lambda rows: _batched_membership(
            rows, self._features, self.radii[k], self.row_batch_size))

    def evaluate(self, eval_features, return_realism: bool = False,
                 return_neighbors: bool = False):
        """(E, len(nhood_sizes)) int32 membership, optionally with the
        realism score ``max_j radii_j / (d_ij + eps)`` and the nearest
        reference index per sample, in the reference's tuple order; one
        fused distance pass feeds every output."""
        ev = _as_features(eval_features, self.device)
        radii_mat = torch.stack([self.radii[k] for k in self.nhood_sizes],
                                dim=1)
        col_batch = min(self.row_batch_size, self._features.shape[0])

        def evaluate(rows):
            outs = [_evaluate_rows(rows[i:i + self.row_batch_size],
                                   self._features, radii_mat, col_batch,
                                   self.eps)
                    for i in range(0, rows.shape[0], self.row_batch_size)]
            return tuple(torch.cat(xs) for xs in zip(*outs))

        preds, realism, neighbors = _over_rows(self.mesh, ev, evaluate)
        preds = preds.to(torch.int32)
        if return_realism and return_neighbors:
            return preds, realism, neighbors
        if return_realism:
            return preds, realism
        if return_neighbors:
            return preds, neighbors
        return preds


def knn_precision_recall_features(
    ref_features,
    eval_features,
    nhood_sizes: Sequence[int] = (3,),
    row_batch_size: int = 10000,
    clamp_to_percentile: Optional[float] = None,
    return_realism: bool = False,
    return_neighbors: bool = False,
    device: DeviceLike = "cuda",
    mesh=None,
) -> Dict[str, object]:
    """Precision and recall between reference (real) and eval (generated)
    features on ``device``.

    Returns ``precision``/``recall`` for the first neighbourhood size and
    ``precision_k{k}``/``recall_k{k}`` for each; ``return_realism`` adds
    ``realism`` (float32 per eval sample) and ``return_neighbors``
    ``nearest_neighbors`` (int32 index of each eval sample's nearest
    reference row), both numpy.  ``mesh`` splits every pass's rows over
    the ranks (see the module's docstring)."""
    dev = resolve_device(device)
    ref = _as_features(ref_features, dev)
    ev = _as_features(eval_features, dev)
    kw = dict(nhood_sizes=nhood_sizes, row_batch_size=row_batch_size,
              clamp_to_percentile=clamp_to_percentile, device=dev, mesh=mesh)
    ref_manifold = ManifoldEstimator(ref, **kw)
    eval_manifold = ManifoldEstimator(ev, **kw)

    state: Dict[str, object] = {}
    ks = ref_manifold.nhood_sizes
    if return_realism or return_neighbors:
        preds, *extras = ref_manifold.evaluate(
            ev, return_realism=return_realism,
            return_neighbors=return_neighbors)
        precision_k = [preds[:, j] for j in range(len(ks))]
        if return_realism:
            state["realism"] = extras[0].cpu().numpy()
        if return_neighbors:
            state["nearest_neighbors"] = extras[-1].cpu().numpy()
    elif len(ks) == 1:
        precision_k = [ref_manifold.membership(ev, ks[0])]
    else:
        preds = ref_manifold.evaluate(ev)
        precision_k = [preds[:, j] for j in range(len(ks))]
    if len(ks) == 1:
        recall_k = [eval_manifold.membership(ref, ks[0])]
    else:
        rec = eval_manifold.evaluate(ref)
        recall_k = [rec[:, j] for j in range(len(ks))]

    for j, k in enumerate(ks):
        state[f"precision_k{k}"] = float(precision_k[j].float().mean())
        state[f"recall_k{k}"] = float(recall_k[j].float().mean())
    state["precision"] = state[f"precision_k{ks[0]}"]
    state["recall"] = state[f"recall_k{ks[0]}"]
    return state
