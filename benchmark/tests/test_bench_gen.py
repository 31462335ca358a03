"""The generator: one seed gives the same tables twice, two seeds give
different tables of the same sizes, and the tables keep the spec's
shapes."""

import torch

from benchmark import tpch_gen

from .conftest import small_config

BIG_SEED = 2 ** 31 + 12_345


def _flat(tables):
    out = {}
    for t, cols in tables.items():
        for k, c in cols.items():
            out[f"{t}.{k}"] = (c.values, c.data)
    return out


def test_same_seed_same_tables():
    cfg = small_config()
    a = _flat(tpch_gen.make_tables(cfg, BIG_SEED, "cpu"))
    b = _flat(tpch_gen.make_tables(cfg, BIG_SEED, "cpu"))
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k][0], b[k][0]), k
        assert (a[k][1] is None) == (b[k][1] is None), k
        if a[k][1] is not None:
            assert torch.equal(a[k][1], b[k][1]), k


def test_two_seeds_differ_in_values_not_sizes():
    cfg = small_config()
    a = tpch_gen.make_tables(cfg, 7, "cpu")
    b = tpch_gen.make_tables(cfg, 8, "cpu")
    assert a["lineitem"]["l_shipdate"].values.shape == \
        b["lineitem"]["l_shipdate"].values.shape
    assert a["customer"]["c_acctbal"].values.shape == \
        b["customer"]["c_acctbal"].values.shape
    for t, k in (("lineitem", "l_partkey"), ("lineitem", "l_discount"),
                 ("orders", "o_orderdate"), ("customer", "c_nationkey"),
                 ("part", "p_type"), ("partsupp", "ps_availqty"),
                 ("supplier", "s_nationkey")):
        assert not torch.equal(a[t][k].values, b[t][k].values), (t, k)
    assert not torch.equal(a["lineitem"]["l_comment"].data[:1000],
                           b["lineitem"]["l_comment"].data[:1000])
    # orders count follows each seed's lines per order: within 5%
    na = a["orders"]["o_orderkey"].values.shape[0]
    nb = b["orders"]["o_orderkey"].values.shape[0]
    assert abs(na - nb) <= 0.05 * na


def test_spec_shapes():
    t = tpch_gen.make_tables(small_config(), BIG_SEED, "cpu")
    li, o = t["lineitem"], t["orders"]
    assert len(li) == 16 and len(o) == 9 and len(t["customer"]) == 8
    n = li["l_orderkey"].values.shape[0]
    assert n == small_config()["rows"]["lineitem"]
    # every line's order exists, keys ascending; ship after order date
    okey = o["o_orderkey"].values
    assert bool((okey[1:] > okey[:-1]).all())
    row = torch.searchsorted(okey, li["l_orderkey"].values)
    assert bool((okey[row] == li["l_orderkey"].values).all())
    odate = o["o_orderdate"].values[row]
    ship = li["l_shipdate"].values
    assert bool(((ship - odate >= 1) & (ship - odate <= 121)).all())
    cents = torch.round(li["l_discount"].values * 100)
    assert bool(((cents >= 0) & (cents <= 10)).all())
    assert set(li["l_returnflag"].words) == {"A", "N", "R"}
    assert bool((o["o_custkey"].values % 3 != 0).all())
    c = t["customer"]
    assert c["c_name"].strings(torch.tensor([0]))[0] == "Customer#000000001"
    offs = li["l_comment"].values
    lens = offs[1:] - offs[:-1]
    assert int(lens.min()) >= 10 and int(lens.max()) <= 43


def test_part_supplier_shapes():
    """part, partsupp, supplier and region by the spec's rules, and every
    line's (part, supplier) pair one of partsupp's."""
    t = tpch_gen.make_tables(small_config(), BIG_SEED, "cpu")
    suppliers = small_config()["rows"]["supplier"]
    p, ps, s, r = t["part"], t["partsupp"], t["supplier"], t["region"]
    assert (len(p), len(ps), len(s), len(r)) == (9, 5, 7, 3)
    assert p["p_partkey"].values.shape[0] == 20 * suppliers
    assert ps["ps_partkey"].values.shape[0] == 80 * suppliers
    names = p["p_name"].strings(torch.arange(50))
    assert all(len(set(n.split())) == 5 and set(n.split()) <=
               set(tpch_gen.COLORS) for n in names)
    mfgr = p["p_mfgr"].strings(torch.arange(50))
    brand = p["p_brand"].strings(torch.arange(50))
    assert all(b[6] == m[-1] for m, b in zip(mfgr, brand))
    size = p["p_size"].values
    assert int(size.min()) >= 1 and int(size.max()) <= 50
    cost = torch.round(ps["ps_supplycost"].values * 100)
    assert int(cost.min()) >= 100 and int(cost.max()) <= 100_000
    pairs = ps["ps_partkey"].values * 2 ** 32 + ps["ps_suppkey"].values
    assert pairs.unique().shape == pairs.shape
    li = t["lineitem"]
    line_pairs = li["l_partkey"].values * 2 ** 32 + li["l_suppkey"].values
    assert bool(torch.isin(line_pairs, pairs).all())
    assert s["s_name"].strings(torch.tensor([0]))[0] == "Supplier#000000001"
    assert r["r_name"].strings(torch.arange(5)) == list(tpch_gen.REGIONS)
