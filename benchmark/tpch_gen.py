"""TPC-H's eight tables as plain tensors, made on one device from a seed by
the spec's rules (TPC-H 3.0.1, clause 4.2.3).

The benchmark hands the same tensors to the program (which wraps them as
its own columns) and to the plain reference.  Nothing here imports the
program.  Every stream of random numbers is splitmix64 over a range of
row numbers whose offset is drawn from the seed, and the text pool that
comments are cut from is drawn from the seed too: one seed gives the same
tables twice, two seeds give different tables of the same sizes.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

EPOCH = datetime.date(1970, 1, 1)
CURRENTDATE = datetime.date(1995, 6, 17)           # spec 4.2.3
SHIPINSTRUCT = ("DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN")
SHIPMODE = ("REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB")
SEGMENTS = ("AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD")
PRIORITIES = ("1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW")
NATIONS = (                                         # (n_name, n_regionkey)
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4), ("JAPAN", 2),
    ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0), ("MOZAMBIQUE", 0),
    ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3), ("SAUDI ARABIA", 4),
    ("VIETNAM", 2), ("RUSSIA", 3), ("UNITED KINGDOM", 3),
    ("UNITED STATES", 1))
REGIONS = ("AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST")
COLORS = (                                          # P_NAME's words
    "almond antique aquamarine azure beige bisque black blanched blue blush "
    "brown burlywood burnished chartreuse chiffon chocolate coral cornflower "
    "cornsilk cream cyan dark deep dim dodger drab firebrick floral forest "
    "frosted gainsboro ghost goldenrod green grey honeydew hot indian ivory "
    "khaki lace lavender lawn lemon light lime linen magenta maroon medium "
    "metallic midnight mint misty moccasin navajo navy olive orange orchid "
    "pale papaya peach peru pink plum powder puff purple red rose rosy royal "
    "saddle salmon sandy seashell sienna sky slate smoke snow spring steel "
    "tan thistle tomato turquoise violet wheat white yellow").split()
TYPES = tuple(f"{a} {b} {c}"
              for a in ("STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY",
                        "PROMO")
              for b in ("ANODIZED", "BURNISHED", "PLATED", "POLISHED",
                        "BRUSHED")
              for c in ("TIN", "NICKEL", "BRASS", "STEEL", "COPPER"))
CONTAINERS = tuple(f"{a} {b}" for a in ("SM", "LG", "MED", "JUMBO", "WRAP")
                   for b in ("CASE", "BOX", "BAG", "JAR", "PKG", "PACK",
                             "CAN", "DRUM"))


@dataclass
class Col:
    """One column as plain tensors.  `kind` is int64, int32, float64,
    date32 (int32 day numbers), dict (int32 `values` indexing `words`),
    utf8 or large_utf8 (`values` the offsets, `data` the bytes)."""
    kind: str
    values: torch.Tensor
    data: Optional[torch.Tensor] = None
    words: Optional[Tuple[str, ...]] = None

    def strings(self, rows: torch.Tensor) -> list:
        """The Python strings of `rows` (a dict or text column)."""
        rows = rows.tolist()
        if self.kind == "dict":
            codes = self.values[torch.tensor(rows, dtype=torch.long,
                                             device=self.values.device)]
            return [self.words[c] for c in codes.tolist()]
        offs = self.values.cpu()
        out = []
        for r in rows:
            a, b = int(offs[r]), int(offs[r + 1])
            out.append(bytes(self.data[a:b].cpu().numpy()).decode())
        return out


def days(d) -> int:
    """Day number of a date or an ISO 'YYYY-MM-DD' string."""
    if isinstance(d, str):
        d = datetime.date.fromisoformat(d)
    return (d - EPOCH).days


# ---- splitmix64 on int64 storage ------------------------------------------

def _lsr(x, k):
    """Logical shift right on int64 storage."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def _mix2(h: torch.Tensor) -> torch.Tensor:
    """splitmix64's two rounds, u64 bits in int64 storage."""
    h = (h ^ _lsr(h, 30)) * (0xBF58476D1CE4E5B9 - (1 << 64))
    return (h ^ _lsr(h, 27)) * (0x94D049BB133111EB - (1 << 64))


def splitmix(n: int, offset: int, device) -> torch.Tensor:
    """The hash of i = arange(n) + offset + 7, u64 bits in int64 storage."""
    return _mix2(torch.arange(n, dtype=torch.int64, device=device)
                 + (offset + 7))


def umod(h: torch.Tensor, m: int) -> torch.Tensor:
    """u64 h % m on int64 storage."""
    return ((_lsr(h, 1) % m) * 2 + (h & 1)) % m


def seed_base(seed: int) -> int:
    """The offset every stream of this seed starts from: splitmix64 of the
    seed, cut to 40 bits so that offsets plus row numbers stay far from
    2^63."""
    h = (int(seed) + 0x9E3779B97F4A7C15) % (1 << 64)
    h = ((h ^ (h >> 30)) * 0xBF58476D1CE4E5B9) % (1 << 64)
    h = ((h ^ (h >> 27)) * 0x94D049BB133111EB) % (1 << 64)
    return (h ^ (h >> 31)) >> 24


# ---- the text pool (spec 4.2.2.13-14) --------------------------------------

def _weighted(spec: str):
    """'word:weight ...' (underscores for spaces) -> (words, p)."""
    pairs = [w.rsplit(":", 1) for w in spec.split()]
    weights = np.array([float(k) for _, k in pairs])
    return [w.replace("_", " ") for w, _ in pairs], weights / weights.sum()


# spec 4.2.2.13's word classes, with weights as dbgen's dists.dss gives them
GRAMMAR = {
    "noun": _weighted(
        "packages:40 requests:40 accounts:40 deposits:40 foxes:20 ideas:20 "
        "theodolites:20 pinto_beans:20 instructions:20 dependencies:10 "
        "excuses:10 platelets:10 asymptotes:10 courts:5 dolphins:5 "
        "multipliers:1 sauternes:1 warthogs:1 frets:1 dinos:1 attainments:1 "
        "somas:1 Tiresias:1 patterns:1 forges:1 braids:1 frays:1 "
        "warhorses:1 dugouts:1 notornis:1 epitaphs:1 pearls:1 tithes:1 "
        "waters:1 orbits:1 gifts:1 sheaves:1 depths:1 sentiments:1 decoys:1 "
        "realms:1 pains:1 grouches:1 escapades:1 hockey_players:1"),
    "verb": _weighted(
        "sleep:20 wake:20 are:20 cajole:20 haggle:20 nag:10 use:10 boost:10 "
        "affix:5 detect:5 integrate:5 maintain:1 nod:1 was:1 lose:1 "
        "sublate:1 solve:1 thrash:1 promise:1 engage:1 hinder:1 print:1 "
        "x-ray:1 breach:1 eat:1 grow:1 impress:1 mold:1 poach:1 serve:1 "
        "run:1 dazzle:1 snooze:1 doze:1 unwind:1 kindle:1 play:1 hang:1 "
        "believe:1 doubt:1"),
    "adjective": _weighted(
        "special:20 pending:20 unusual:20 express:20 furious:1 sly:1 "
        "careful:1 blithe:1 quick:1 fluffy:1 slow:1 quiet:1 ruthless:1 "
        "thin:1 close:1 dogged:1 daring:1 brave:1 stealthy:1 permanent:1 "
        "enticing:1 idle:1 busy:1 regular:50 final:40 ironic:40 even:30 "
        "bold:20 silent:10"),
    "adverb": _weighted(
        "sometimes:1 always:1 never:1 furiously:50 slyly:50 carefully:50 "
        "blithely:40 quickly:30 fluffily:20 slowly:1 quietly:1 ruthlessly:1 "
        "thinly:1 closely:1 doggedly:1 daringly:1 bravely:1 stealthily:1 "
        "permanently:1 enticingly:1 idly:1 busily:1 regularly:1 finally:1 "
        "ironically:1 evenly:1 boldly:1 silently:1"),
    "preposition": _weighted(
        "about:50 above:50 according_to:50 across:50 after:50 against:40 "
        "along:40 alongside_of:30 among:30 around:20 at:10 atop:1 before:1 "
        "behind:1 beneath:1 beside:1 besides:1 between:1 beyond:1 by:1 "
        "despite:1 during:1 except:1 for:1 from:1 in_place_of:1 inside:1 "
        "instead_of:1 into:1 near:1 of:1 on:1 outside:1 over:1 past:1 "
        "since:1 through:1 throughout:1 to:1 toward:1 under:1 until:1 up:1 "
        "upon:1 without:1 with:1 within:1"),
    "auxiliary": _weighted(
        "do:1 may:1 might:1 shall:1 will:1 would:1 can:1 could:1 should:1 "
        "ought_to:1 must:1 will_have_to:1 shall_have_to:1 could_have_to:1 "
        "should_have_to:1 must_have_to:1 need_to:1 try_to:1"),
    "terminator": _weighted(".:50 ;:1 :::1 ?:1 !:1 --:1"),
}
# spec 4.2.2.14: sentence, noun phrase and verb phrase shapes (weights)
SENTENCES = (("NVT", 3), ("NVPT", 3), ("NVNT", 3), ("NPVNT", 1),
             ("NPVPT", 1))
NOUN_PHRASES = (("n", 10), ("jn", 20), ("j,jn", 10), ("djn", 50))
VERB_PHRASES = (("v", 30), ("xv", 1), ("vd", 40), ("xvd", 1))


def text_pool(rng, nbytes: int) -> np.ndarray:
    """dbgen's text pool: sentences of the grammar, space-separated, until
    `nbytes` bytes; comments are cut from it at random offsets."""
    def pick(kind, k):
        words, p = GRAMMAR[kind]
        return [words[i] for i in rng.choice(len(words), k, p=p)]

    def shapes(table, k):
        names = [s for s, _ in table]
        w = np.array([x for _, x in table], float)
        return [names[i] for i in rng.choice(len(names), k, p=w / w.sum())]

    phrase = {"n": "noun", "j": "adjective", "d": "adverb", "v": "verb",
              "x": "auxiliary"}
    out, size, batch = [], 0, 4096
    while size < nbytes:
        sent = shapes(SENTENCES, batch)
        draws = {k: iter(pick(k, 8 * batch)) for k in GRAMMAR}
        nps = iter(shapes(NOUN_PHRASES, 4 * batch))
        vps = iter(shapes(VERB_PHRASES, 2 * batch))

        def render(shape):
            words = []
            for c in shape:
                if c == ",":
                    words[-1] += ","
                else:
                    words.append(next(draws[phrase[c]]))
            return " ".join(words)
        for s in sent:
            parts = []
            for c in s:
                if c == "N":
                    parts.append(render(next(nps)))
                elif c == "V":
                    parts.append(render(next(vps)))
                elif c == "P":
                    parts.append(next(draws["preposition"]) + " the "
                                 + render(next(nps)))
            text = " ".join(parts) + next(draws["terminator"]) + " "
            out.append(text)
            size += len(text)
    return np.frombuffer("".join(out).encode()[:nbytes], np.uint8).copy()


def cut(pool: torch.Tensor, starts: torch.Tensor, lens: torch.Tensor,
        chunk_bytes: int = 1 << 28):
    """(int64 offsets, bytes) of pool[starts[i]:starts[i] + lens[i]] on the
    pool's device, about `chunk_bytes` bytes at a time."""
    n = lens.shape[0]
    dev = lens.device
    offs = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    torch.cumsum(lens, 0, out=offs[1:])
    data = torch.empty(int(offs[-1]), dtype=torch.uint8, device=dev)
    chunk = max(1, chunk_bytes // max(int(lens.max()) if n else 1, 1))
    for a in range(0, n, chunk):
        b = min(a + chunk, n)
        lo, hi = int(offs[a]), int(offs[b])
        rid = torch.repeat_interleave(torch.arange(b - a, device=dev),
                                      lens[a:b], output_size=hi - lo)
        pos = torch.arange(hi - lo, device=dev) - (offs[a:b] - lo)[rid]
        data[lo:hi] = pool[starts[a:b][rid] + pos]
    return offs, data


def digits(v: torch.Tensor, width: int) -> torch.Tensor:
    """(n, width) ASCII digits of v, zero-padded."""
    p = 10 ** torch.arange(width - 1, -1, -1, device=v.device)
    return (48 + (v[:, None] // p) % 10).to(torch.uint8)


def fixed_rows(parts) -> Col:
    """A utf8 column of fixed-width rows: `parts` are bytes (the same in
    every row) or (n, w) uint8 tensors, joined left to right."""
    n = next(p.shape[0] for p in parts if isinstance(p, torch.Tensor))
    dev = next(p.device for p in parts if isinstance(p, torch.Tensor))
    cols = [p if isinstance(p, torch.Tensor) else torch.tensor(
        list(p), dtype=torch.uint8, device=dev).expand(n, len(p))
        for p in parts]
    rows = torch.cat(cols, 1)
    w = rows.shape[1]
    return Col("utf8", torch.arange(n + 1, dtype=torch.int32, device=dev) * w,
               rows.reshape(-1).contiguous())


def word_rows(idx: torch.Tensor, words, sep: str = " ") -> Col:
    """A utf8 column whose row i is words[idx[i, 0]], sep, words[idx[i,
    1]], ... joined."""
    n, k = idx.shape
    dev = idx.device
    table = list(words) + [sep]
    blob = torch.tensor(list("".join(table).encode()), dtype=torch.uint8,
                        device=dev)
    wlen = torch.tensor([len(w.encode()) for w in table], device=dev)
    wstart = torch.cumsum(wlen, 0) - wlen
    tok = torch.full((n, 2 * k - 1), len(words), dtype=torch.int64,
                     device=dev)
    tok[:, 0::2] = idx
    tok = tok.reshape(-1)
    offs, data = cut(blob, wstart[tok], wlen[tok])
    return Col("utf8", offs[0::2 * k - 1].to(torch.int32).contiguous(),
               data)


def distinct_draws(s, n: int, of: int, k: int, first: int) -> torch.Tensor:
    """(n, k) indices below `of`, distinct within a row, uniform: the
    j-th is drawn among those the row has not taken yet (streams `first`
    to `first` + k - 1)."""
    taken = torch.empty((n, 0), dtype=torch.int64, device=s.device)
    for j in range(k):
        x = umod(s(n, first + j), of - j)
        for p in torch.sort(taken, 1).values.unbind(1):
            x = x + (x >= p)
        taken = torch.cat([taken, x[:, None]], 1)
    return taken


def phone(nation: torch.Tensor, s, k: int) -> Col:
    """Phone numbers by spec 4.2.2.9: the country code from the nation,
    three random groups (streams k to k + 2)."""
    n, dash = nation.shape[0], b"-"
    return fixed_rows([digits(nation + 10, 2), dash,
                       digits(100 + umod(s(n, k), 900), 3), dash,
                       digits(100 + umod(s(n, k + 1), 900), 3), dash,
                       digits(1000 + umod(s(n, k + 2), 9000), 4)])


class _Streams:
    """splitmix streams of one seed: stream k covers row numbers
    [base + k * span, base + (k + 1) * span)."""

    def __init__(self, seed: int, span: int, device):
        self.base, self.span, self.device = seed_base(seed), span, device

    def __call__(self, n: int, k: int) -> torch.Tensor:
        return splitmix(n, self.base + k * self.span, self.device)


def _text(pool, s: _Streams, n: int, lo: int, hi: int, k: int,
          large: bool) -> Col:
    """n comments of lo-hi bytes cut from the pool at random offsets."""
    lens = lo + umod(s(n, k), hi - lo + 1)
    starts = umod(s(n, k + 1), pool.shape[0] - hi)
    offs, data = cut(pool, starts, lens)
    if large:
        return Col("large_utf8", offs, data)
    return Col("utf8", offs.to(torch.int32), data)


def lineitem_orders(n: int, customers: int, suppliers: int, s: _Streams,
                    pool: torch.Tensor):
    """lineitem (16 columns) and orders (9) by spec 4.2.3: orders of 1-7
    lines under sparse keys (the first 8 of every 32), parts over SF's
    200,000 per SF, suppliers by the spec's formula, l_extendedprice =
    l_quantity * p_retailprice, discounts 0.00-0.10, taxes 0.00-0.08, the
    dates, the flags from the receipt and ship dates against CURRENTDATE;
    each order's status, total price and date from its lines, o_custkey
    over the customers not divisible by 3.  Money is Float64, the cents
    over 100."""
    dev = s.device
    m = n // 4 + n // 100 + 1_000          # 4 lines an order on average
    lines = 1 + umod(s(m, 6), 7)
    ends = torch.cumsum(lines, 0)
    n_orders = int((ends < n).sum()) + 1
    lines = lines[:n_orders].clone()
    lines[-1] -= int(ends[n_orders - 1]) - n          # the last order cut
    order = torch.repeat_interleave(torch.arange(n_orders, device=dev),
                                    lines, output_size=n)
    first = torch.cumsum(lines, 0) - lines
    linenumber = (torch.arange(n, device=dev) - first[order] + 1).to(
        torch.int32)
    okeys = (torch.arange(n_orders, device=dev) // 8) * 32 \
        + torch.arange(n_orders, device=dev) % 8 + 1
    lo, hi = days("1992-01-01"), days("1998-12-31") - 151
    odate = lo + umod(s(n_orders, 0), hi - lo + 1)        # an order's date
    odate_row = odate[order]
    ship = (odate_row + 1 + umod(s(n, 1), 121)).to(torch.int32)
    commit = (odate_row + 30 + umod(s(n, 2), 61)).to(torch.int32)
    receipt = (ship + 1 + umod(s(n, 3), 30)).to(torch.int32)
    del odate_row
    qty = 1 + umod(s(n, 4), 50)
    part = 1 + umod(s(n, 7), 20 * suppliers)           # P = SF * 200,000
    retail = 90_000 + (part // 10) % 20_001 + 100 * (part % 1_000)
    price = qty * retail                                 # cents
    disc = umod(s(n, 8), 11)
    tax = umod(s(n, 9), 9)
    current = days(CURRENTDATE)
    flag = torch.where(receipt <= current, 2 * umod(s(n, 10), 2), 1)  # R/A, N
    status = (ship > current).to(torch.int32)                # F 0, O 1
    i = umod(s(n, 11), 4)
    supp = (part + i * (suppliers // 4 + (part - 1) // suppliers)) \
        % suppliers + 1
    del i

    def money(cents):
        return Col("float64", cents.to(torch.float64) / 100)

    lineitem = {
        "l_orderkey": Col("int64", okeys[order]),
        "l_partkey": Col("int64", part),
        "l_suppkey": Col("int64", supp),
        "l_linenumber": Col("int32", linenumber),
        "l_quantity": money(qty * 100),
        "l_extendedprice": money(price),
        "l_discount": money(disc),
        "l_tax": money(tax),
        "l_returnflag": Col("dict", flag.to(torch.int32), words=("A", "N",
                                                                 "R")),
        "l_linestatus": Col("dict", status, words=("F", "O")),
        "l_shipdate": Col("date32", ship),
        "l_commitdate": Col("date32", commit),
        "l_receiptdate": Col("date32", receipt),
        "l_shipinstruct": Col("dict", umod(s(n, 12), len(SHIPINSTRUCT)).to(
            torch.int32), words=SHIPINSTRUCT),
        "l_shipmode": Col("dict", umod(s(n, 13), len(SHIPMODE)).to(
            torch.int32), words=SHIPMODE),
        "l_comment": _text(pool, s, n, 10, 43, 14, False)}
    del qty, part, retail, ship, commit

    open_ = torch.zeros(n_orders, dtype=torch.int64, device=dev).index_add_(
        0, order, status.to(torch.int64))
    ostatus = torch.where(open_ == 0, 0, torch.where(open_ == lines, 1, 2))
    charge = torch.zeros(n_orders, dtype=torch.int64, device=dev).index_add_(
        0, order, price * (100 + tax) * (100 - disc))
    del open_, price, tax, disc, order, status
    k3 = umod(s(n_orders, 16), 2 * customers // 3)
    clerks = max(n // 6_000, 1)                   # SF * 1,000
    clerk_names = fixed_rows([b"Clerk#", digits(
        torch.arange(1, clerks + 1, device=dev), 9)])
    clerk_words = tuple(bytes(clerk_names.data.cpu().numpy()).decode()[
        i * 15:(i + 1) * 15] for i in range(clerks))
    orders = {
        "o_orderkey": Col("int64", okeys),
        "o_custkey": Col("int64", 3 * (k3 // 2) + 1 + k3 % 2),
        "o_orderstatus": Col("dict", ostatus.to(torch.int32),
                             words=("F", "O", "P")),
        "o_totalprice": money((charge + 5_000) // 10_000),
        "o_orderdate": Col("date32", odate.to(torch.int32)),
        "o_orderpriority": Col("dict", umod(s(n_orders, 18), 5).to(
            torch.int32), words=PRIORITIES),
        "o_clerk": Col("dict", umod(s(n_orders, 17), clerks).to(torch.int32),
                       words=clerk_words),
        "o_shippriority": Col("int32", torch.zeros(
            n_orders, dtype=torch.int32, device=dev)),
        "o_comment": _text(pool, s, n_orders, 19, 78, 19, True)}
    return lineitem, orders


def customer_nation(customers: int, s: _Streams, pool: torch.Tensor):
    """customer and nation by spec 4.2.3; the comments (and c_address)
    cut from the pool."""
    dev = s.device
    nc = customers
    key = torch.arange(1, nc + 1, device=dev)
    nation = umod(s(nc, 21), 25)
    customer = {
        "c_custkey": Col("int64", key),
        "c_name": fixed_rows([b"Customer#", digits(key, 9)]),
        "c_address": _text(pool, s, nc, 10, 40, 25, False),
        "c_nationkey": Col("int64", nation),
        "c_phone": phone(nation, s, 22),
        "c_acctbal": Col("float64", (umod(s(nc, 27), 1_099_999) - 99_999)
                         .to(torch.float64) / 100),
        "c_mktsegment": Col("dict", umod(s(nc, 28), 5).to(torch.int32),
                            words=SEGMENTS),
        "c_comment": _text(pool, s, nc, 29, 116, 29, True)}
    names = "".join(a for a, _ in NATIONS).encode()
    lens = torch.tensor([len(a) for a, _ in NATIONS], device=dev)
    offs = torch.zeros(26, dtype=torch.int32, device=dev)
    offs[1:] = torch.cumsum(lens, 0)
    nation_t = {
        "n_nationkey": Col("int64", torch.arange(25, device=dev)),
        "n_name": Col("utf8", offs, torch.tensor(list(names),
                                                  dtype=torch.uint8,
                                                  device=dev)),
        "n_regionkey": Col("int64", torch.tensor([b for _, b in NATIONS],
                                                 device=dev)),
        "n_comment": _text(pool, s, 25, 31, 114, 31, True)}
    return customer, nation_t


def part_supplier(suppliers: int, s: _Streams, pool: torch.Tensor):
    """part (SF * 200,000 rows), partsupp (4 a part, the suppliers by the
    formula lineitem's l_suppkey follows), supplier and region by spec
    4.2.3.  Supplier comments carry no Better Business Bureau
    sentences."""
    dev = s.device
    npart = 20 * suppliers
    pkey = torch.arange(1, npart + 1, device=dev)
    mfgr = umod(s(npart, 40), 5)
    part = {
        "p_partkey": Col("int64", pkey),
        "p_name": word_rows(distinct_draws(s, npart, len(COLORS), 5, 35),
                            COLORS),
        "p_mfgr": Col("dict", mfgr.to(torch.int32), words=tuple(
            f"Manufacturer#{m}" for m in range(1, 6))),
        "p_brand": Col("dict", (5 * mfgr + umod(s(npart, 41), 5)).to(
            torch.int32), words=tuple(f"Brand#{m}{b}" for m in range(1, 6)
                                      for b in range(1, 6))),
        "p_type": Col("dict", umod(s(npart, 42), len(TYPES)).to(torch.int32),
                      words=TYPES),
        "p_size": Col("int32", (1 + umod(s(npart, 43), 50)).to(torch.int32)),
        "p_container": Col("dict", umod(s(npart, 44), len(CONTAINERS)).to(
            torch.int32), words=CONTAINERS),
        "p_retailprice": Col("float64", (90_000 + (pkey // 10) % 20_001
                                         + 100 * (pkey % 1_000)).to(
                                             torch.float64) / 100),
        "p_comment": _text(pool, s, npart, 5, 22, 45, False)}
    del mfgr
    nps = 4 * npart
    pk = torch.repeat_interleave(pkey, 4, output_size=nps)
    i = torch.arange(nps, device=dev) % 4
    partsupp = {
        "ps_partkey": Col("int64", pk),
        "ps_suppkey": Col("int64", (pk + i * (suppliers // 4 + (pk - 1)
                                              // suppliers)) % suppliers
                          + 1),
        "ps_availqty": Col("int32", (1 + umod(s(nps, 56), 9_999)).to(
            torch.int32)),
        "ps_supplycost": Col("float64", (100 + umod(s(nps, 57), 99_901)).to(
            torch.float64) / 100),
        "ps_comment": _text(pool, s, nps, 49, 198, 58, True)}
    del pk, i
    skey = torch.arange(1, suppliers + 1, device=dev)
    snation = umod(s(suppliers, 49), 25)
    supplier = {
        "s_suppkey": Col("int64", skey),
        "s_name": fixed_rows([b"Supplier#", digits(skey, 9)]),
        "s_address": _text(pool, s, suppliers, 10, 40, 47, False),
        "s_nationkey": Col("int64", snation),
        "s_phone": phone(snation, s, 50),
        "s_acctbal": Col("float64", (umod(s(suppliers, 53), 1_099_999)
                                     - 99_999).to(torch.float64) / 100),
        "s_comment": _text(pool, s, suppliers, 25, 100, 54, True)}
    names = "".join(REGIONS).encode()
    offs = torch.zeros(len(REGIONS) + 1, dtype=torch.int32, device=dev)
    offs[1:] = torch.cumsum(torch.tensor([len(r) for r in REGIONS],
                                         device=dev), 0)
    region = {
        "r_regionkey": Col("int64", torch.arange(len(REGIONS), device=dev)),
        "r_name": Col("utf8", offs, torch.tensor(list(names),
                                                  dtype=torch.uint8,
                                                  device=dev)),
        "r_comment": _text(pool, s, len(REGIONS), 31, 115, 33, True)}
    return part, partsupp, supplier, region


def make_tables(cfg: dict, seed: int, device) -> Dict[str, Dict[str, Col]]:
    """The configuration's tables (`rows`: lineitem, customer and supplier
    counts; `text_pool_bytes`) made on `device` from `seed`."""
    rows = cfg["rows"]
    n, nc = rows["lineitem"], rows["customer"]
    pool = torch.from_numpy(text_pool(np.random.default_rng(seed),
                                      cfg["text_pool_bytes"])).to(device)
    s = _Streams(seed, max(n, 1 << 20), device)
    lineitem, orders = lineitem_orders(n, nc, rows["supplier"], s, pool)
    customer, nation = customer_nation(nc, s, pool)
    part, partsupp, supplier, region = part_supplier(rows["supplier"], s,
                                                     pool)
    return {"lineitem": lineitem, "orders": orders, "customer": customer,
            "nation": nation, "part": part, "partsupp": partsupp,
            "supplier": supplier, "region": region}
