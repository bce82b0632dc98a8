"""Augmented inform stage (paper §IV-A, Fig. 1 BuildPeerNetwork).

Epidemic propagation: each rank ROOTS one epidemic that floods its own
``RankSummary`` (rank info + cluster summaries — the augmentation over
load-only gossip [22] that CCM requires) over ``k_rounds`` rounds of
``fanout`` randomly selected peers.  A recipient that learns the root's
summary forwards the message; one that already knows it drops it (dedupe:
the delivery cannot change the destination's knowledge).

**Per-root streams.**  Every root draws its forward targets from its OWN
``default_rng`` stream, keyed ``[seed, iteration, root]`` via
:func:`gossip_root_key` (SeedSequence mixes the tuple, so distinct keys
give distinct, collision-free streams).  Because roots never share a
stream, one root's epidemic is completely independent of every other's —
this is what makes the amortized ("quiescence") path possible: a rank
whose summary did not change since iteration ``e`` keeps the key
``[seed, e, root]``, so its epidemic is *bitwise the same draw* whether it
is re-run from scratch (the rebuild reference) or replayed from a cached
reach set (:func:`update_peer_networks`).  Only roots whose summary
actually changed advance their iteration stamp and re-draw.

The payload of a root's epidemic is exactly ``{root: summaries[root]}``
and is never copied or merged with other roots' knowledge: a rank's
``info_known`` map is the set-union of the roots whose floods reached it
(plus itself).  The union is order-independent, so the incremental and
full paths produce identical maps even though they assemble them in
different orders; downstream work-list scoring canonicalizes by sorting
on ``(-diff, peer)``.

This is a deterministic discrete-event simulation of R ranks: messages
sent in round k are delivered at round k+1.  The port's copy of
``repro/core/gossip.py``, without the async driver's fault hooks.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.clusters import RankSummary

GossipKey = Tuple[int, ...]


def gossip_seed(seed: int, it: int) -> list:
    """Collision-free per-iteration gossip stream key.

    ``default_rng`` accepts a sequence seed, which SeedSequence mixes
    entropy-pool style — distinct ``(seed, it)`` pairs give distinct
    streams, unlike the old ``seed * 1000 + it`` arithmetic where e.g.
    ``(seed=1, it=1000)`` and ``(seed=2, it=0)`` collided.  Every driver
    derives its per-iteration gossip stream through this one helper (the
    JAX package's drivers too), so the parity bars stay aligned.
    """
    return [int(seed), int(it)]


def gossip_root_key(seed, root: int) -> list:
    """Per-root epidemic stream key: ``seed`` (an int, or the
    ``gossip_seed(seed, it)`` pair) extended with the root rank."""
    base = list(seed) if isinstance(seed, (list, tuple)) else [int(seed)]
    return base + [int(root)]


def root_epidemic(n: int, root: int, *, k_rounds: int, fanout: int,
                  key, stats: Optional[dict] = None) -> List[int]:
    """Flood one root's summary; returns the reached ranks in delivery
    order (root excluded).

    Deterministic in ``(n, root, k_rounds, fanout, key)`` alone — the
    root's rng stream is private, so re-running with the same key
    reproduces the same reach bitwise no matter what other roots do.
    """
    rng = np.random.default_rng(key)
    reached = {root}
    order: List[int] = []
    base_visited = {root}
    msgs: List[tuple] = [
        (1, p, frozenset([root, p]))
        for p in pick_peers(rng, n, root, fanout, visited=base_visited)]
    while msgs:
        nxt: List[tuple] = []
        for rnd, dst, visited in msgs:
            if dst in reached:      # dedupe: no merge, no forward
                if stats is not None:
                    stats["gossip_noop_merges"] = \
                        stats.get("gossip_noop_merges", 0) + 1
                continue
            reached.add(dst)
            order.append(dst)
            if rnd < k_rounds:
                for p in pick_peers(rng, n, dst, fanout,
                                    visited=set(visited)):
                    nxt.append((rnd + 1, p, frozenset(visited) | {p}))
        msgs = nxt
    return order


def build_peer_networks(summaries: Dict[int, RankSummary], *, k_rounds: int,
                        fanout: int, seed=0,
                        root_seeds: Optional[Dict[int, list]] = None,
                        reach_out: Optional[Dict[int, List[int]]] = None,
                        stats: Optional[dict] = None,
                        ) -> Dict[int, Dict[int, RankSummary]]:
    """Returns per-rank ``info_known``: rank -> {peer -> RankSummary}.

    The full (rebuild) path: every root's epidemic is re-run.  ``seed``
    may be an int or a ``gossip_seed(seed, it)`` pair; ``root_seeds``
    overrides the per-root key outright (the drivers pass
    ``gossip_root_key(gossip_seed(seed, epoch[root]), root)`` so a quiet
    root replays the iteration it last changed in).  ``reach_out``, when
    given, receives each root's delivery-order reach list — the cacheable
    artifact :func:`update_peer_networks` patches incrementally.
    """
    ranks = sorted(summaries)
    n = len(ranks)
    info_known: Dict[int, Dict[int, RankSummary]] = {
        r: {r: summaries[r]} for r in ranks}
    for root in ranks:
        key = (root_seeds[root] if root_seeds is not None
               else gossip_root_key(seed, root))
        order = root_epidemic(n, root, k_rounds=k_rounds, fanout=fanout,
                              key=key, stats=stats)
        if reach_out is not None:
            reach_out[root] = order
        payload = summaries[root]
        for dst in order:
            info_known[dst][root] = payload
    return info_known


def update_peer_networks(summaries: Dict[int, RankSummary],
                         info_known: Dict[int, Dict[int, RankSummary]],
                         reach: Dict[int, List[int]], *,
                         k_rounds: int, fanout: int,
                         root_seeds: Dict[int, list],
                         dirty_roots: Sequence[int],
                         stats: Optional[dict] = None) -> Set[int]:
    """Patch a peer network in place: re-run ONLY the epidemics rooted at
    ``dirty_roots`` (roots whose summary — and hence key — changed),
    splicing their old reach out of and new reach into the per-rank maps.

    Returns the set of ranks whose ``info_known`` content changed (union
    of old and new reach of every dirty root, plus the dirty roots
    themselves) — exactly the ranks whose work lists need re-scoring.
    Bitwise-equal to a full :func:`build_peer_networks` under the same
    ``root_seeds`` because clean roots' epidemics are pure functions of
    their unchanged keys.
    """
    n = len(summaries)
    affected: Set[int] = set()
    for root in sorted(dirty_roots):
        root = int(root)
        affected.add(root)
        old = reach.get(root, [])
        for dst in old:
            info_known[dst].pop(root, None)
            affected.add(dst)
        order = root_epidemic(n, root, k_rounds=k_rounds, fanout=fanout,
                              key=root_seeds[root], stats=stats)
        reach[root] = order
        payload = summaries[root]
        info_known[root][root] = payload    # re-bind the fresh summary
        for dst in order:
            info_known[dst][root] = payload
            affected.add(dst)
        if stats is not None:
            stats["gossip_redraws"] = stats.get("gossip_redraws", 0) + 1
    return affected


def pick_peers(rng, n: int, me: int, fanout: int, visited: Set[int]):
    """``fanout`` forward targets excluding ``visited`` — the epidemic's
    only source of randomness; consumption order must match between the
    two drivers for the zero-latency parity bar (it does: both pick at
    delivery time from the root's private stream, and zero latency
    reproduces each root's round order)."""
    candidates = [r for r in range(n) if r != me and r not in visited]
    if not candidates:
        return []
    k = min(fanout, len(candidates))
    return list(rng.choice(candidates, size=k, replace=False))
