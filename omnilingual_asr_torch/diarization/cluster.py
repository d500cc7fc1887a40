"""Speaker clustering: agglomerative (average-linkage) clustering over

The PyTorch port's own copy of ``omnilingual_asr_tpu/diarization/cluster.py`` (the port imports nothing
of the JAX package); keep the two in step.
L2-normalized segment speaker embeddings.

Replaces the diarization the reference outsources to Gemini (prompt
requirement #1, reference gemini_pipeline.py:204). Because clustering runs
once over ALL segments of a file — across chunk boundaries — speaker labels
are globally consistent, fixing the reference's known defect where each 300 s
chunk independently restarts at "Speaker 1" (SURVEY.md §5, long-context row;
reference merge at gemini_pipeline.py:643-678 never reconciles labels).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

# Cosine-distance merge threshold for unknown speaker counts. Untuned
# (no trained speaker model yet); conservative default.
DEFAULT_THRESHOLD = 0.45


def ahc_labels(embeds: np.ndarray, n_clusters: Optional[int] = None,
               threshold: float = DEFAULT_THRESHOLD) -> np.ndarray:
    """Average-linkage AHC on cosine distance.

    embeds: [N, D] (need not be normalized). If ``n_clusters`` is given
    (the ``speaker_count`` hint path, reference gemini_pipeline.py:468-469),
    merge to exactly that many clusters; otherwise merge while the closest
    pair is under ``threshold``.

    Returns int labels [N] renumbered by first appearance (0, 1, ...), so
    label 0 is the first speaker heard — matching "Speaker 1" semantics.

    Large files route through scipy's C linkage: the pure-numpy merge loop
    re-scans the full N^2 distance matrix per merge, which at the 9.5 h
    envelope (7,373 segments) was measured at ~15 min of the assemble
    stage; scipy does the same average-linkage dendrogram in seconds.
    """
    n = len(embeds)
    if n == 0:
        return np.zeros((0,), dtype=np.int64)
    x = embeds / np.maximum(np.linalg.norm(embeds, axis=1, keepdims=True), 1e-9)
    if n_clusters is not None:
        n_clusters = max(1, min(int(n_clusters), n))
    if n == 1 or n_clusters == 1:
        return np.zeros((n,), dtype=np.int64)

    if n > 64:
        try:
            return _ahc_labels_scipy(x, n_clusters, threshold)
        except ImportError:  # pragma: no cover — scipy ships with jax
            pass

    # Distance matrix (cosine distance).
    d = 1.0 - x @ x.T
    np.fill_diagonal(d, np.inf)
    # Active cluster bookkeeping: members per cluster; distances kept
    # average-linkage via weighted (Lance-Williams) update.
    sizes = np.ones(n)
    active = np.ones(n, dtype=bool)
    parent = np.arange(n)

    def n_active():
        return int(active.sum())

    target = n_clusters if n_clusters is not None else 1
    while n_active() > target:
        i, j = np.unravel_index(np.argmin(d), d.shape)
        if n_clusters is None and d[i, j] > threshold:
            break
        if i > j:
            i, j = j, i
        # Average-linkage distance update into cluster i.
        wi, wj = sizes[i], sizes[j]
        new_d = (wi * d[i] + wj * d[j]) / (wi + wj)
        d[i, :] = new_d
        d[:, i] = new_d
        d[i, i] = np.inf
        d[j, :] = np.inf
        d[:, j] = np.inf
        sizes[i] = wi + wj
        active[j] = False
        parent[parent == j] = i

    # Renumber by first appearance.
    labels = np.full(n, -1, dtype=np.int64)
    next_label = 0
    for k in range(n):
        root = parent[k]
        first = np.flatnonzero(parent == root)[0]
        if labels[first] == -1:
            labels[first] = next_label
            next_label += 1
        labels[k] = labels[first]
    return labels


def _ahc_labels_scipy(x: np.ndarray, n_clusters: Optional[int],
                      threshold: float) -> np.ndarray:
    """Average-linkage via scipy (C implementation): same dendrogram as the
    numpy loop — merge while the closest average-linkage pair is <= cut —
    with the same first-appearance renumbering."""
    from scipy.cluster.hierarchy import fcluster, linkage
    from scipy.spatial.distance import squareform

    d = 1.0 - x @ x.T
    # Clip tiny negative/asymmetric float residue; squareform requires a
    # symmetric zero-diagonal matrix.
    d = np.maximum((d + d.T) * 0.5, 0.0)
    np.fill_diagonal(d, 0.0)
    Z = linkage(squareform(d, checks=False), method="average")
    if n_clusters is not None:
        raw = fcluster(Z, t=n_clusters, criterion="maxclust")
    else:
        raw = fcluster(Z, t=threshold, criterion="distance")
    # Renumber by first appearance (label 0 = first speaker heard).
    uniq, first_idx = np.unique(raw, return_index=True)
    remap = np.empty(int(raw.max()) + 1, dtype=np.int64)
    remap[uniq[np.argsort(first_idx)]] = np.arange(len(uniq))
    return remap[raw]


def estimate_n_speakers(embeds: np.ndarray, max_k: int = 8,
                        top_frac: float = 0.4) -> Optional[int]:
    """Spectral eigengap speaker-count estimation (round-4, VERDICT r3 #5).

    Threshold-stopped AHC gets the speaker COUNT wrong on 6/16 eval
    conversations (e.g. ref 4 -> hyp 2, DER 0.437) because one global merge
    cut cannot fit every conversation's embedding geometry. The standard
    fix (spectral clustering literature: Wang et al. 2018, NME-SC) reads
    the count from the affinity spectrum instead:

    1. cosine affinity, per-row sparsification (keep the top ``top_frac``
       entries, zero the rest — prunes weak cross-speaker links),
    2. symmetrize, normalized Laplacian L = I - D^-1/2 A D^-1/2,
    3. k* = argmax of the eigengap among the smallest ``max_k`` eigenvalues
       (k tight clusters -> k near-zero eigenvalues, then a jump).

    Returns None when there are too few segments to read a spectrum
    (n < 4) — callers fall back to threshold stopping.
    """
    n = len(embeds)
    if n < 4:
        return None
    x = embeds / np.maximum(
        np.linalg.norm(embeds, axis=1, keepdims=True), 1e-9)
    a = x @ x.T
    a = np.clip(a, 0.0, None)          # negative cosine = no affinity
    np.fill_diagonal(a, 0.0)
    # Row-wise sparsification: keep each segment's strongest links.
    keep = max(2, int(np.ceil(top_frac * n)))
    if keep < n:
        cut = np.partition(a, n - keep, axis=1)[:, n - keep][:, None]
        a = np.where(a >= cut, a, 0.0)
    a = np.maximum(a, a.T)             # symmetric (max keeps kept links)
    np.fill_diagonal(a, 1.0)
    d = a.sum(axis=1)
    d_inv_sqrt = 1.0 / np.sqrt(np.maximum(d, 1e-12))
    lap = np.eye(n) - (d_inv_sqrt[:, None] * a * d_inv_sqrt[None, :])
    evals = np.linalg.eigvalsh(lap)    # ascending
    k_max = min(max_k, n - 1)
    gaps = evals[1:k_max + 1] - evals[:k_max]
    return int(np.argmax(gaps) + 1)


def resegment_labels(embeds: np.ndarray, labels: np.ndarray,
                     *, temperature: float = 0.08,
                     switch_penalty: float = 1.6,
                     n_iters: int = 3) -> np.ndarray:
    """VBx-style HMM resegmentation over AHC labels (VERDICT r3 #5).

    AHC assigns each segment independently of its neighbours; real
    conversations have speaker *runs*, and the segments AHC gets wrong are
    mostly low-margin outliers inside a run. This pass re-decodes the
    time-ordered segment sequence with a speaker HMM (the lightweight
    analogue of VBx resegmentation, Landini et al. 2022 — diagonalized to
    cosine scores since there is no PLDA model here):

    - states   = the AHC clusters,
    - emission = log-softmax over clusters of (embedding . centroid) / T,
    - transition = 0 to stay, -switch_penalty to change speaker,

    Viterbi-decode, re-estimate centroids from the new labels, repeat
    until stable (<= ``n_iters``). Clusters never *gain* members they are
    far from (emission dominates for confident segments); only weak
    segments inside runs flip. Empty clusters after a pass are dropped.

    embeds must be in time order. Returns first-appearance-renumbered
    labels like :func:`ahc_labels`.
    """
    n = len(embeds)
    k = int(labels.max()) + 1 if n else 0
    if n < 3 or k < 2:
        return labels
    x = embeds / np.maximum(
        np.linalg.norm(embeds, axis=1, keepdims=True), 1e-9)
    cur = labels.astype(np.int64).copy()
    for _ in range(n_iters):
        # Centroids of the current assignment (L2-normalized).
        cents = np.zeros((k, x.shape[1]))
        for c in range(k):
            m = cur == c
            if m.any():
                cents[c] = x[m].mean(axis=0)
        norms = np.linalg.norm(cents, axis=1)
        alive = norms > 1e-9
        if alive.sum() < 2:
            break
        cents[alive] /= norms[alive, None]
        sims = x @ cents.T                      # [n, k]
        sims[:, ~alive] = -np.inf
        logp = sims / max(temperature, 1e-6)
        logp -= _logsumexp(logp, axis=1)[:, None]
        # Viterbi with uniform start, stay=0 / switch=-penalty transitions.
        delta = logp[0].copy()
        back = np.zeros((n, k), dtype=np.int64)
        for t in range(1, n):
            # score[j -> c] = delta[j] + (0 if j==c else -penalty)
            best_prev = delta.max()
            cand = np.where(delta == best_prev)[0][0]
            stay = delta
            move = best_prev - switch_penalty
            keep = stay >= move
            delta = np.where(keep, stay, move) + logp[t]
            back[t] = np.where(keep, np.arange(k), cand)
        new = np.zeros(n, dtype=np.int64)
        new[-1] = int(np.argmax(delta))
        for t in range(n - 2, -1, -1):
            new[t] = back[t + 1][new[t + 1]]
        if (new == cur).all():
            cur = new
            break
        cur = new
    # First-appearance renumbering (drops emptied clusters).
    uniq, first_idx = np.unique(cur, return_index=True)
    remap = np.empty(int(cur.max()) + 1, dtype=np.int64)
    remap[uniq[np.argsort(first_idx)]] = np.arange(len(uniq))
    return remap[cur]


def _logsumexp(a: np.ndarray, axis: int) -> np.ndarray:
    m = np.max(a, axis=axis, keepdims=True)
    m = np.where(np.isfinite(m), m, 0.0)
    return (np.log(np.sum(np.exp(a - m), axis=axis))
            + np.squeeze(m, axis=axis))


def cluster_speakers(embeds: np.ndarray, *, n_clusters: Optional[int] = None,
                     threshold: float = DEFAULT_THRESHOLD,
                     count_mode: str = "threshold",
                     max_k: int = 8,
                     resegment: bool = False) -> np.ndarray:
    """AHC with either threshold stopping (legacy) or spectral eigengap
    count estimation ("eigengap"): the estimated count pins the dendrogram
    cut, with threshold fallback when the spectrum is unreadable. With
    ``resegment``, a speaker-HMM Viterbi pass (``resegment_labels``)
    smooths low-margin assignments over the time axis afterwards."""
    if n_clusters is None and count_mode == "eigengap":
        n_clusters = estimate_n_speakers(embeds, max_k=max_k)
    labels = ahc_labels(embeds, n_clusters=n_clusters, threshold=threshold)
    if resegment:
        labels = resegment_labels(embeds, labels)
    return labels
