"""The card level: the node axis over several cards of one host, driven by
one process (the reference's multi-chip mesh: one controller whose
shard_map program runs on every chip, kubernetes_tpu/parallel/mesh.py).

Card c of C holds the contiguous node range [c * Nb / C, (c + 1) * Nb / C)
of every node plane as a tensor of its own (CardTensor, dim 0; the
affinity table's columns, dim 1), and a copy of every other input
(CardTensor, dim None). The wave scan (K6), the single-pod cycle (K4) and
the pods x nodes matrix (K7) run one instance per card, all launched before
anything waits, each on its card's range, their reductions crossing cards
inside the kernels through peer memory (csrc/comm.cuh CardComm). K1 and K3
run on each card's own range with no new device code: a pod's NodeName and
affinity pin are node indices, so each card gets them shifted into its
range (-2, which no node matches, where the node is another card's).

The state every card reads and writes (the scan's domain tables, the
hard-spread counts, the signature table's segs/pcs/valid; K4's and K7's
domain tables) has one copy, on card 0 (the home card), in device memory.
The scan's winners, cursor, overflow and tier counts are written on every
card; the carry planes, sig_scores and the signature table's columns stay
on their cards, and a chained wave reads them there.

Two card ranks may share one card (devices=[cuda:0, cuda:0]): the second
rank's launches go on a side stream, and each launch is refused unless the
card holds every rank's blocks at once. On the CPU the plain versions
concatenate the cards' parts, run the one-card plain version under
ShardComm and split the outputs back.

No fallback: a pair of cards without peer access raises when the card set
is made; a rank that never arrives (a bounded spin ran out) raises at
check(); a CUDA tensor never takes a plain version.
"""

from __future__ import annotations

import itertools

import torch

from . import kernels as _k
from .cuda import CARD_MAX

# card-level launches by kernel (K6 sharded_assign, K4 fit_and_score, K7
# wave_fit_and_score): each card-level call adds one here and one to the
# kernel's own count (kernels.LAUNCHES); reset_launches() zeroes both
CARD_LAUNCHES = _k.CARD_LAUNCHES

# the inbox words of one slot group (csrc/comm.cuh: [2 parities][CARD_MAX
# source cards][CARD_SLOT words])
CARD_SLOT = 16
GROUP_WORDS = 2 * CARD_MAX * CARD_SLOT

# the launch counter every card-level launch takes its sequence numbers
# from (epoch << 32): a slot's word from an earlier launch never matches
_EPOCH = itertools.count(1)


class CardTensor:
    """One kernel input or output over the cards: parts[c] on card c. dim
    is the node axis the parts split (their concatenation along it is the
    whole), or None for a copy on every card (parts[0] is the value)."""

    __slots__ = ("parts", "dim")

    def __init__(self, parts, dim):
        self.parts = tuple(parts)
        self.dim = dim

    @property
    def shape(self) -> tuple:
        s = list(self.parts[0].shape)
        if self.dim is not None:
            s[self.dim] = sum(p.shape[self.dim] for p in self.parts)
        return tuple(s)

    @property
    def dtype(self):
        return self.parts[0].dtype

    @property
    def device(self) -> torch.device:
        return self.parts[0].device

    @property
    def nbytes(self) -> int:
        return sum(p.numel() * p.element_size() for p in self.parts)

    def numel(self) -> int:
        n = 1
        for x in self.shape:
            n *= x
        return n

    def map(self, fn) -> "CardTensor":
        return CardTensor([fn(p) for p in self.parts], self.dim)

    def clone(self) -> "CardTensor":
        return self.map(torch.Tensor.clone)

    def view(self, *shape) -> "CardTensor":
        if self.dim is not None:
            raise ValueError("a node-split CardTensor has no view")
        return self.map(lambda p: p.view(*shape))

    def __getitem__(self, key) -> "CardTensor":
        if self.dim is not None:
            raise ValueError("index a node-split CardTensor by its parts")
        return self.map(lambda p: p[key])

    def cpu(self) -> torch.Tensor:
        """The whole value on the host (the parts' concatenation)."""
        if self.dim is None:
            return self.parts[0].cpu()
        return torch.cat([p.cpu() for p in self.parts], dim=self.dim)

    def numpy(self):
        return self.cpu().numpy()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a if dtype is None else a.astype(dtype)

    def whole(self) -> torch.Tensor:
        """The whole value on the first part's device (plain versions)."""
        if self.dim is None:
            return self.parts[0]
        return torch.cat([p.to(self.device) for p in self.parts], dim=self.dim)

    def __repr__(self) -> str:
        return f"CardTensor(shape={self.shape}, dim={self.dim}, cards={len(self.parts)})"


def card_ranges(nb: int, cards: int) -> list[tuple[int, int]]:
    """The node range [lo, hi) of each card: equal contiguous parts."""
    if nb % cards:
        raise ValueError(f"node bucket {nb} not divisible by {cards} cards")
    per = nb // cards
    return [(c * per, (c + 1) * per) for c in range(cards)]


def split(t: torch.Tensor, dim, devices) -> CardTensor:
    """t cut into len(devices) contiguous node ranges along dim (None: a copy
    on each card), part c on devices[c]."""
    if dim is None:
        return CardTensor([t.to(d, copy=True) for d in devices], None)
    n = t.shape[dim]
    lo_hi = card_ranges(n, len(devices))
    return CardTensor([t.narrow(dim, lo, hi - lo).to(d, copy=True).contiguous()
                       for (lo, hi), d in zip(lo_hi, devices)], dim)


def _part(x, c: int):
    return x.parts[c] if isinstance(x, CardTensor) else x


def _whole(x):
    return x.whole() if isinstance(x, CardTensor) else x


def _parts_dict(d: dict, c: int) -> dict:
    return {k: _part(v, c) for k, v in d.items()}


class CardSet:
    """The cards of a mesh's node axis (devices[c] holds card rank c; a card
    may carry two ranks), their peer access and their exchange buffers: per
    card an inbox of slot groups (grown by doubling; a grown-out buffer is
    kept, since a peer may still write it) and four control words ([0] a
    spin ran out, [1] the card exchanges of its last launch)."""

    def __init__(self, devices):
        self.devices = tuple(torch.device(d) for d in devices)
        self.n = len(self.devices)
        if not 1 <= self.n <= CARD_MAX:
            raise ValueError(f"{self.n} cards: the card level holds 1 to {CARD_MAX}")
        kinds = {d.type for d in self.devices}
        if len(kinds) != 1:
            raise ValueError(f"cards of mixed kinds: {self.devices}")
        self.on_card = self.devices[0].type == "cuda"
        self.devices = tuple(self._indexed(d) for d in self.devices)
        # the rank's place among the ranks of its card (0: the card's
        # current stream; else a side stream of its own)
        seen: dict = {}
        self.slot = []
        for d in self.devices:
            self.slot.append(seen.get(d, 0))
            seen[d] = seen.get(d, 0) + 1
        self.ranks_on = [seen[d] for d in self.devices]
        self._side: dict = {}
        self._inbox: list = []
        self._groups = 0
        self._old: list = []
        self.ctl: list = []
        if self.on_card:
            from . import cuda

            distinct = sorted({d.index for d in self.devices})
            for a in distinct:
                for b in distinct:
                    if a != b:
                        cuda.enable_peer_access(a, b)
            self.ctl = [torch.zeros(4, dtype=torch.int32, device=d) for d in self.devices]
            self._grow(1)

    @staticmethod
    def _indexed(d: torch.device) -> torch.device:
        if d.type == "cuda" and d.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        return d

    def _grow(self, groups: int) -> None:
        if groups <= self._groups:
            return
        g = max(groups, 2 * self._groups, 1)
        self._old.append(self._inbox)
        self._inbox = [torch.zeros(g * GROUP_WORDS, dtype=torch.int32, device=d)
                       for d in self.devices]
        self._groups = g
        for d in set(self.devices):
            torch.cuda.synchronize(d)

    def streams(self) -> list:
        """Every rank's stream for one launch, taken before any rank
        launches: a side stream that waits for its card's current stream
        after the first rank's launch would wait for that kernel, which
        waits for this rank."""
        return [self.stream(c) for c in range(self.n)]

    def stream(self, c: int):
        """Rank c's stream: its card's current stream, or for a second rank
        on a card a side stream that first waits for the current one (take
        every rank's with streams() before launching any)."""
        dev = self.devices[c]
        cur = torch.cuda.current_stream(dev)
        if self.slot[c] == 0:
            return cur
        side = self._side.get(c)
        if side is None:
            # non-blocking: a stream that waits for the legacy default stream
            # would hold this rank back until the first rank's kernel ends,
            # while that kernel waits for this rank at its first exchange
            from . import cuda

            with torch.cuda.device(dev):
                side = torch.cuda.ExternalStream(cuda.create_nonblocking_stream(), device=dev)
            self._side[c] = side
        side.wait_stream(cur)
        return side

    def join(self) -> None:
        """Each card's current stream waits for its side streams (after a
        launch: later work on the card sees the second rank's outputs)."""
        for c, side in self._side.items():
            torch.cuda.current_stream(self.devices[c]).wait_stream(side)

    def links(self, groups: int, node_offs: list[int], outs: list | None = None):
        """One CardParams per rank for one launch of `groups` slot groups."""
        from . import cuda

        self._grow(groups)
        epoch = next(_EPOCH)
        links = []
        for c in range(self.n):
            lk = cuda.CardParams(card=c, cards=self.n, node_off=int(node_offs[c]), group0=0)
            lk.seq = epoch << 32
            for q in range(self.n):
                lk.inbox[q] = self._inbox[q].data_ptr()
                if outs is not None:
                    lk.outs[q] = outs[q].data_ptr()
            lk.ctl = self.ctl[c].data_ptr()
            links.append(lk)
        return links

    def card_exchanges(self) -> int:
        """Card exchanges of the last launch (card 0's count; syncs the card)."""
        return int(self.ctl[0][1].item()) if self.on_card else 0

    def check(self) -> None:
        """Raise where a rank never arrived at a card exchange (a bounded spin
        ran out) in any launch since the last check, and clear the word."""
        if not self.on_card:
            return
        bad = [c for c in range(self.n) if int(self.ctl[c][0].item())]
        for c in bad:
            self.ctl[c][0] = 0
        if bad:
            raise RuntimeError(f"card level: a card rank never arrived at an exchange "
                               f"(cards {bad} ran out of their bounded spin)")


def _shift_feats(packed_f: torch.Tensor, layout, off: int, nbc: int) -> torch.Tensor:
    """A copy of the packed features with NodeName and the affinity pin (node
    indices) moved into the card's range [off, off + nbc): -1 stays -1, a
    node of another card becomes -2, which no node matches."""
    cols = {name: o for name, o, _w, _nd, _tag in layout}
    out = packed_f.clone()
    for name in ("name_idx", "aff_pin"):
        x = out[:, cols[name]]
        inside = (x >= off) & (x < off + nbc)
        out[:, cols[name]] = torch.where(x == -1, x, torch.where(inside, x - off,
                                                                 torch.full_like(x, -2)))
    return out


# -- K6 -----------------------------------------------------------------------


def card_scan_plan(cfg, nbc: int, shards: int, R: int, S: int, max_blocks: int):
    """K6's plan on one card of a card-level launch: the GTAB instance (the
    domain tables on the home card) on the fewest power-of-two blocks from
    `shards` that hold one pass of the card's range; past the card's
    largest cluster it raises (the card level runs one-pass instances)."""
    from . import cuda

    p = cuda.ScanParams(R=R, S=S, **_k._cfg_scan_fields(cfg))
    p.gtab = 1
    blocks, npt = _k._scan_blocks(p, nbc, shards, False, None)
    if not blocks or blocks > max_blocks:
        raise ValueError(f"sharded_assign (card level): {nbc} node slots a card need more "
                         f"than the card's cluster of {max_blocks} blocks in one pass")
    return _k.ScanPlan(blocks, npt, True)


def cards_assign(cfg, planes: dict, tables: dict, packed_f: CardTensor, layout,
                 tie_words: CardTensor, logtab: CardTensor, cards: CardSet, shards: int,
                 cursor_init=0, sig_ids=None, uniq_idx=None, frame_shift: int = 0,
                 carry_map=None, sig_table=None) -> dict:
    """K1 + K6 at the card level: batched_assign's outputs over the cards'
    node ranges, `shards` node shards (blocks of K6's cluster) per card.
    Returns packed (a copy on every card: winners as global node indices,
    cursor, overflow), the carry planes, sig_scores and the signature
    table's ew/ffit/feas split by card (dim 0 or 1), segs/pcs on card 0,
    tiers on every card. cursor_init: an int, or a copy on every card of the
    predecessor's cursor word (packed[P])."""
    _k.check_slice(cfg)
    C = cards.n
    nbc = planes["alloc"].parts[0].shape[0]
    if not cards.on_card:
        return cards_assign_ref(cfg, planes, tables, packed_f, layout, tie_words, logtab, C,
                                shards, cursor_init, sig_ids, uniq_idx, frame_shift,
                                carry_map, sig_table)
    cap = _k.scan_limits(cards.devices[0])["max_blocks"]
    R, S = planes["alloc"].parts[0].shape[1], planes["sel_counts"].parts[0].shape[1]
    plan = card_scan_plan(cfg, nbc, shards, R, S, cap)
    fast = sig_ids is not None
    P = packed_f.parts[0].shape[0]
    # the results on every card first: K6 writes each winner into all of them
    packed = [torch.empty(P + 2, dtype=torch.int32, device=d) for d in cards.devices]
    links = cards.links(1, [c * nbc for c in range(C)], outs=packed)
    home: dict = {}
    outs = []
    launches = []
    streams = cards.streams()
    for c in range(C):
        dev = cards.devices[c]
        with torch.cuda.device(dev):
            stream = streams[c]
            with torch.cuda.stream(stream):
                f_c = _shift_feats(packed_f.parts[c], layout, c * nbc, nbc)
                pl = _parts_dict(planes, c)
                tb = _parts_dict(tables, c)
                static = _k.static_parts(pl, tb, f_c, layout, rows=_part(uniq_idx, c))
                st = None
                if sig_table is not None:
                    st = {k: (_part(v, c) if k in ("ew", "ffit", "feas") else v)
                          for k, v in sig_table.items()}
                cur = _part(cursor_init, c)
                p, out, ptrs, keep = _k._assign(
                    cfg, pl, static, f_c, layout, _part(tie_words, c), cur, _part(logtab, c),
                    shards, _part(sig_ids, c), _part(uniq_idx, c), frame_shift,
                    _part(carry_map, c), st, plan=plan, home=home if c else None,
                    packed=packed[c], launch=False, log_nb=nbc * C)
                if c == 0:
                    home = keep
                from . import cuda

                # (f_c and K1's outputs ride along: the launch reads them
                # through bare pointers)
                launches.append((c, cuda.ShardParams(scan=p, blocks=plan.blocks), ptrs,
                                 stream, (f_c, static)))
                outs.append(out)
    # every card's K1 is queued; now every card's K6, nothing waited on
    from . import cuda

    for c, params, ptrs, stream, _inputs in launches:
        with torch.cuda.device(cards.devices[c]):
            cuda.launch_cards("sharded_assign", params, ptrs, links[c], cards.ranks_on[c],
                              stream.cuda_stream)
    cards.join()
    _k.count_launch("sharded_assign")
    CARD_LAUNCHES["sharded_assign"] += 1
    res = {"packed": CardTensor(packed, None)}
    for k in outs[0]:
        if k in ("packed", "sig_table"):
            continue
        dim = 1 if k == "sig_scores" else (None if k == "tiers" else 0)
        res[k] = CardTensor([o[k] for o in outs], dim)
    if fast:
        tab = {k: CardTensor([o["sig_table"][k] for o in outs], 1) for k in ("ew", "ffit",
                                                                           "feas")}
        tab["segs"] = outs[0]["sig_table"]["segs"]
        tab["pcs"] = outs[0]["sig_table"]["pcs"]
        res["sig_table"] = tab
    return res


def cards_assign_ref(cfg, planes, tables, packed_f, layout, tie_words, logtab, C, shards,
                     cursor_init=0, sig_ids=None, uniq_idx=None, frame_shift=0, carry_map=None,
                     sig_table=None) -> dict:
    """Plain version of the card-level K1 + K6 (on any device: the oracle
    chip_smoke holds the kernels against): the cards' parts concatenated
    on card 0, the plain K1 and the plain scan under ShardComm(cards x
    shards), the outputs split back to the cards as cards_assign returns
    them."""
    from .planes import unpack_features

    whole = {k: _whole(v) for k, v in planes.items()}
    tabs = {k: _whole(v) for k, v in tables.items()}
    f = unpack_features(packed_f.parts[0], layout)
    rows = _part(uniq_idx, 0)
    static = _k.static_parts_ref(whole, tabs, f if rows is None else
                                 {k: v[rows.long()] for k, v in f.items()})
    st = None
    if sig_table is not None:
        st = {k: _whole(v) for k, v in sig_table.items()}
    cur = _part(cursor_init, 0)
    out = _k.sharded_assign_ref(cfg, whole, static, f, _part(tie_words, 0), cur,
                                _part(logtab, 0), C * shards, _part(sig_ids, 0),
                                _part(uniq_idx, 0), frame_shift, _part(carry_map, 0), st)
    devices = [p.device for p in planes["alloc"].parts]
    res = {"packed": CardTensor([out["packed"].clone() for _ in devices], None)}
    for k, v in out.items():
        if k in ("packed", "sig_table"):
            continue
        dim = 1 if k == "sig_scores" else (None if k == "tiers" else 0)
        res[k] = split(v, dim, devices)
    if "sig_table" in out:
        tab = {k: split(out["sig_table"][k], 1, devices) for k in ("ew", "ffit", "feas")}
        tab["segs"], tab["pcs"] = out["sig_table"]["segs"], out["sig_table"]["pcs"]
        res["sig_table"] = tab
    return res


# -- K4 and K7 ----------------------------------------------------------------


def _fit_card_inputs(cfg, planes, tables, packed_f, layout, logtab, cards, c, nbc, cluster):
    """Card c's FitParams (the GTAB instance: the tables on card 0) and input
    pointers, and its pods' features with their node indices shifted into
    its range (the caller holds them until the launch)."""
    f_c = _shift_feats(packed_f.parts[c], layout, c * nbc, nbc)
    nf = len(_k.FILTER_NAMES) + 2 * cfg.max_constraints + 3
    p, ptrs = _k._fit_inputs(cfg, _parts_dict(planes, c), _parts_dict(tables, c), f_c, layout,
                             _part(logtab, c), nf, cluster, log_nb=nbc * cards.n)
    p.gtab = 1
    return p, ptrs, f_c


def cards_fit_and_score(cfg, planes: dict, tables: dict, packed_f: CardTensor, layout,
                        logtab: CardTensor, cards: CardSet, cluster: int | None = None,
                        syncs: torch.Tensor | None = None) -> CardTensor:
    """K4 at the card level: each pod against every card's node range, one
    cluster of `cluster` blocks per pod and card. Returns each card's packed
    outputs [P, bytes] over its range (CardTensor, dim -1: unpack each with
    unpack_fit_outputs at the card's bucket; fit_outputs joins them). syncs:
    card 0's pod 0 counts, as K4's."""
    _k.check_fit_slice(cfg)
    cluster = _k.FIT_CLUSTER if cluster is None else cluster
    if cluster not in _k.FIT_CLUSTERS:
        raise ValueError(f"fit_and_score runs on a cluster of {_k.FIT_CLUSTERS} blocks, "
                         f"not {cluster}")
    C = cards.n
    nbc, R = planes["alloc"].parts[0].shape
    nf = len(_k.FILTER_NAMES) + 2 * cfg.max_constraints + 3
    if not cards.on_card:
        return cards_fit_and_score_ref(cfg, planes, tables, packed_f, layout, logtab)
    from . import cuda

    if nbc % 8:
        raise ValueError(f"fit_and_score (card level): {nbc} node rows a card; the packed "
                         "outputs' int32 rows need a multiple of 8")
    P = packed_f.parts[0].shape[0]
    _, per_pod = _k.fit_output_bytes(nbc, nf, R)
    outs = [torch.empty((P, per_pod), dtype=torch.uint8, device=d) for d in cards.devices]
    if not P:
        return CardTensor(outs, -1)
    links = cards.links(P, [c * nbc for c in range(C)])
    scratch = None
    streams = cards.streams()
    for c in range(C):
        dev = cards.devices[c]
        with torch.cuda.device(dev):
            stream = streams[c]
            with torch.cuda.stream(stream):
                # f_c held until the launch has read its pointer
                p, ptrs, f_c = _fit_card_inputs(cfg, planes, tables, packed_f, layout, logtab,
                                                cards, c, nbc, cluster)
                if scratch is None:
                    scratch = _k._fit_scratch(p, P, dev)
                cuda.launch_cards("fit_and_score", p,
                                  ptrs + [outs[c].data_ptr(),
                                          _k._fit_syncs_ptr(syncs if c == 0 else None, dev),
                                          scratch.data_ptr(), _k._launch_tables_ptr(cfg, dev)],
                                  links[c], cards.ranks_on[c], stream.cuda_stream)
    cards.join()
    _k.count_launch("fit_and_score")
    CARD_LAUNCHES["fit_and_score"] += 1
    res = CardTensor(outs, -1)
    return res


def cards_fit_and_score_ref(cfg, planes: dict, tables: dict, packed_f: CardTensor, layout,
                            logtab) -> CardTensor:
    """Plain version of the card-level K4 (on any device): K4's plain
    version over the concatenated parts, each card's outputs cut out."""
    from .planes import unpack_features

    whole = {k: _whole(v) for k, v in planes.items()}
    f = unpack_features(packed_f.parts[0], layout)
    tabs = {k: _whole(v) for k, v in tables.items()}
    nb, R = whole["alloc"].shape
    nf = len(_k.FILTER_NAMES) + 2 * cfg.max_constraints + 3
    rows = [_k._pack_fit_outputs(_k.fit_and_score_ref(cfg, whole, tabs, f, _part(logtab, 0),
                                                      p))
            for p in range(packed_f.parts[0].shape[0])]
    out = (torch.stack(rows) if rows else
           torch.empty((0, _k.fit_output_bytes(nb, nf, R)[1]), dtype=torch.uint8,
                       device=whole["alloc"].device))
    return _split_fit(out, nb, nf, R, [p.device for p in planes["alloc"].parts])


def _split_fit(whole: torch.Tensor, nb: int, nf: int, R: int, devices) -> CardTensor:
    """Whole packed K4 outputs [P, bytes] → each card's packed outputs over
    its node range."""
    C = len(devices)
    rows = [[] for _ in range(C)]
    for row in whole:
        o = _unpack(row, nb, nf, R)
        for c, (lo, hi) in enumerate(card_ranges(nb, C)):
            part = {k: (v[..., lo:hi] if not isinstance(v, dict)
                        else {n: x[lo:hi] for n, x in v.items()}) for k, v in o.items()}
            rows[c].append(_k._pack_fit_outputs(part))
    nbc = nb // C
    per_pod = _k.fit_output_bytes(nbc, nf, R)[1]
    return CardTensor([torch.stack(r).to(d) if r else torch.empty((0, per_pod),
                                                                   dtype=torch.uint8,
                                                                   device=d)
                       for r, d in zip(rows, devices)], -1)


def fit_outputs(out: CardTensor, p: int, nf: int, R: int) -> dict:
    """Pod p's outputs of cards_fit_and_score joined over the cards, on the
    host: fit_and_score_ref's dict."""
    parts = []
    for t in out.parts:
        row = t[p].cpu()
        nbc = _nb_of(row.numel(), nf, R)
        parts.append(_unpack(row, nbc, nf, R))
    res = {}
    for k in parts[0]:
        if isinstance(parts[0][k], dict):
            res[k] = {n: torch.cat([q[k][n] for q in parts], dim=-1) for n in parts[0][k]}
        else:
            res[k] = torch.cat([q[k] for q in parts], dim=-1)
    return res


def _unpack(row: torch.Tensor, nb: int, nf: int, R: int) -> dict:
    """unpack_fit_outputs of one card's row, its int32 part copied out (a
    plain version's card of fewer than 8 rows leaves it unaligned)."""
    nbool = _k.fit_output_bytes(nb, nf, R)[0]
    b = row[:nbool].view(torch.bool)
    ints = row[nbool:].clone().view(torch.int32).view(1 + len(_k.PLUGIN_NAMES), nb)
    o = nf * nb
    return {"fails": b[:o].view(nf, nb), "feasible": b[o: o + nb],
            "insufficient": b[o + nb: o + nb + R * nb].view(R, nb),
            "too_many_pods": b[o + nb + R * nb: o + 2 * nb + R * nb], "total": ints[0],
            "per_plugin": {n: ints[1 + i] for i, n in enumerate(_k.PLUGIN_NAMES)}}


def _nb_of(nbytes: int, nf: int, R: int) -> int:
    per_node = _k.fit_output_bytes(1, nf, R)[1]
    return nbytes // per_node


def cards_wave_fit_and_score(cfg, planes: dict, tables: dict, packed_f: CardTensor, layout,
                             logtab: CardTensor, cards: CardSet,
                             syncs: torch.Tensor | None = None):
    """K7 at the card level: the pods x nodes matrix over the cards' node
    ranges, one block per pod and card. Returns (feasible, total), each a
    CardTensor split along the node axis (dim 1)."""
    _k.check_fit_slice(cfg)
    C = cards.n
    nbc = planes["alloc"].parts[0].shape[0]
    devices = [p.device for p in planes["alloc"].parts]
    if not cards.on_card:
        return cards_wave_fit_and_score_ref(cfg, planes, tables, packed_f, layout, logtab)
    from . import cuda

    P = packed_f.parts[0].shape[0]
    feas = [torch.empty((P, nbc), dtype=torch.bool, device=d) for d in cards.devices]
    total = [torch.empty((P, nbc), dtype=torch.int32, device=d) for d in cards.devices]
    if P:
        links = cards.links(P, [c * nbc for c in range(C)])
        scratch = None
        streams = cards.streams()
        for c in range(C):
            dev = cards.devices[c]
            with torch.cuda.device(dev):
                stream = streams[c]
                with torch.cuda.stream(stream):
                    p, ptrs, f_c = _fit_card_inputs(cfg, planes, tables, packed_f, layout,
                                                    logtab, cards, c, nbc, 1)
                    if scratch is None:
                        scratch = _k._fit_scratch(p, P, dev)
                    raw = torch.empty((P, 2, nbc), dtype=torch.int32, device=dev)
                    cuda.launch_cards("wave_fit_and_score", p,
                                      ptrs + [feas[c].data_ptr(), total[c].data_ptr(),
                                              raw.data_ptr(),
                                              _k._fit_syncs_ptr(syncs if c == 0 else None,
                                                                dev),
                                              scratch.data_ptr(),
                                              _k._launch_tables_ptr(cfg, dev)],
                                      links[c], cards.ranks_on[c], stream.cuda_stream)
        cards.join()
        _k.count_launch("wave_fit_and_score")
        CARD_LAUNCHES["wave_fit_and_score"] += 1
    return CardTensor(feas, 1), CardTensor(total, 1)


def cards_wave_fit_and_score_ref(cfg, planes: dict, tables: dict, packed_f: CardTensor,
                                 layout, logtab):
    """Plain version of the card-level K7 (on any device): K7's plain
    version over the concatenated parts, split back by card."""
    from .planes import unpack_features

    devices = [p.device for p in planes["alloc"].parts]
    fe, tot = _k.wave_fit_and_score_ref(cfg, {k: _whole(v) for k, v in planes.items()},
                                        {k: _whole(v) for k, v in tables.items()},
                                        unpack_features(packed_f.parts[0], layout),
                                        _part(logtab, 0))
    return split(fe, 1, devices), split(tot, 1, devices)


def card_floor(cards: CardSet, n: int) -> None:
    """The card level's latency floor (a measurement yardstick no path
    runs): n card exchanges on one block per card, with no node work."""
    from . import cuda

    links = cards.links(1, [0] * cards.n)
    sinks = [torch.empty(1, dtype=torch.int32, device=d) for d in cards.devices]
    streams = cards.streams()
    for c in range(cards.n):
        with torch.cuda.device(cards.devices[c]):
            cuda.launch_card_floor(links[c], n, sinks[c].data_ptr(), streams[c].cuda_stream)
    cards.join()
