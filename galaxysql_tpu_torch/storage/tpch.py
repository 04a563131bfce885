"""TPC-H schema, data generator, and query texts (from the public TPC-H specification).

The reference validates its planner against TPC-H plan fixtures
(`planner/tpch/MppTpchPlan100gTest.java`, SURVEY.md §4); here TPC-H is both the planner
test corpus and the benchmark workload (BASELINE.md configs).

The generator is a simplified dbgen: uniform distributions with the spec's value domains and
cardinality ratios (SF-scaled), deterministic per seed.  It is NOT word-for-word dbgen (no
text grammar); v_strings are drawn from small vocabularies, which keeps dictionaries compact
— representative for engine benchmarking, not for audited TPC-H publication.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

# ---------------------------------------------------------------------------
# schema (spec §1.4) — PolarB-X-flavoured partitioned DDL
# ---------------------------------------------------------------------------

TPCH_DDL = {
    "region": """
        CREATE TABLE region (
            r_regionkey INT NOT NULL PRIMARY KEY,
            r_name      VARCHAR(25) NOT NULL,
            r_comment   VARCHAR(152)
        ) BROADCAST
    """,
    "nation": """
        CREATE TABLE nation (
            n_nationkey INT NOT NULL PRIMARY KEY,
            n_name      VARCHAR(25) NOT NULL,
            n_regionkey INT NOT NULL,
            n_comment   VARCHAR(152)
        ) BROADCAST
    """,
    "supplier": """
        CREATE TABLE supplier (
            s_suppkey   INT NOT NULL PRIMARY KEY,
            s_name      VARCHAR(25) NOT NULL,
            s_address   VARCHAR(40) NOT NULL,
            s_nationkey INT NOT NULL,
            s_phone     VARCHAR(15) NOT NULL,
            s_acctbal   DECIMAL(15,2) NOT NULL,
            s_comment   VARCHAR(101) NOT NULL
        ) PARTITION BY HASH(s_suppkey) PARTITIONS 8
    """,
    "part": """
        CREATE TABLE part (
            p_partkey     INT NOT NULL PRIMARY KEY,
            p_name        VARCHAR(55) NOT NULL,
            p_mfgr        VARCHAR(25) NOT NULL,
            p_brand       VARCHAR(10) NOT NULL,
            p_type        VARCHAR(25) NOT NULL,
            p_size        INT NOT NULL,
            p_container   VARCHAR(10) NOT NULL,
            p_retailprice DECIMAL(15,2) NOT NULL,
            p_comment     VARCHAR(23) NOT NULL
        ) PARTITION BY HASH(p_partkey) PARTITIONS 8
    """,
    "partsupp": """
        CREATE TABLE partsupp (
            ps_partkey    INT NOT NULL,
            ps_suppkey    INT NOT NULL,
            ps_availqty   INT NOT NULL,
            ps_supplycost DECIMAL(15,2) NOT NULL,
            ps_comment    VARCHAR(199) NOT NULL,
            PRIMARY KEY (ps_partkey, ps_suppkey)
        ) PARTITION BY HASH(ps_partkey) PARTITIONS 8
    """,
    "customer": """
        CREATE TABLE customer (
            c_custkey    INT NOT NULL PRIMARY KEY,
            c_name       VARCHAR(25) NOT NULL,
            c_address    VARCHAR(40) NOT NULL,
            c_nationkey  INT NOT NULL,
            c_phone      VARCHAR(15) NOT NULL,
            c_acctbal    DECIMAL(15,2) NOT NULL,
            c_mktsegment VARCHAR(10) NOT NULL,
            c_comment    VARCHAR(117) NOT NULL
        ) PARTITION BY HASH(c_custkey) PARTITIONS 8
    """,
    "orders": """
        CREATE TABLE orders (
            o_orderkey      BIGINT NOT NULL PRIMARY KEY,
            o_custkey       INT NOT NULL,
            o_orderstatus   VARCHAR(1) NOT NULL,
            o_totalprice    DECIMAL(15,2) NOT NULL,
            o_orderdate     DATE NOT NULL,
            o_orderpriority VARCHAR(15) NOT NULL,
            o_clerk         VARCHAR(15) NOT NULL,
            o_shippriority  INT NOT NULL,
            o_comment       VARCHAR(79) NOT NULL
        ) PARTITION BY HASH(o_orderkey) PARTITIONS 8
    """,
    "lineitem": """
        CREATE TABLE lineitem (
            l_orderkey      BIGINT NOT NULL,
            l_partkey       INT NOT NULL,
            l_suppkey       INT NOT NULL,
            l_linenumber    INT NOT NULL,
            l_quantity      DECIMAL(15,2) NOT NULL,
            l_extendedprice DECIMAL(15,2) NOT NULL,
            l_discount      DECIMAL(15,2) NOT NULL,
            l_tax           DECIMAL(15,2) NOT NULL,
            l_returnflag    VARCHAR(1) NOT NULL,
            l_linestatus    VARCHAR(1) NOT NULL,
            l_shipdate      DATE NOT NULL,
            l_commitdate    DATE NOT NULL,
            l_receiptdate   DATE NOT NULL,
            l_shipinstruct  VARCHAR(25) NOT NULL,
            l_shipmode      VARCHAR(10) NOT NULL,
            l_comment       VARCHAR(44) NOT NULL,
            PRIMARY KEY (l_orderkey, l_linenumber)
        ) PARTITION BY HASH(l_orderkey) PARTITIONS 8
    """,
}

TABLE_ORDER = ["region", "nation", "supplier", "part", "partsupp", "customer",
               "orders", "lineitem"]

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1), ("EGYPT", 4),
    ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3), ("INDIA", 2), ("INDONESIA", 2),
    ("IRAN", 4), ("IRAQ", 4), ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0),
    ("MOROCCO", 0), ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3), ("UNITED KINGDOM", 3),
    ("UNITED STATES", 1),
]
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
SHIPINSTRUCT = ["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"]
TYPE_S1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_S2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_S3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
CONTAINERS1 = ["SM", "LG", "MED", "JUMBO", "WRAP"]
CONTAINERS2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]
P_NAME_WORDS = ["almond", "antique", "aquamarine", "azure", "beige", "bisque", "black",
                "blanched", "blue", "blush", "brown", "burlywood", "burnished", "chartreuse",
                "chiffon", "chocolate", "coral", "cornflower", "cornsilk", "cream", "cyan",
                "dark", "deep", "dim", "dodger", "drab", "firebrick", "floral", "forest",
                "frosted", "gainsboro", "ghost", "goldenrod", "green", "grey", "honeydew",
                "hot", "hunter", "indian", "ivory", "khaki", "lace", "lavender", "lawn",
                "lemon", "light", "lime", "linen", "magenta", "maroon", "medium", "metallic",
                "midnight", "mint", "misty", "moccasin", "navajo", "navy", "olive", "orange",
                "orchid", "pale", "papaya", "peach", "peru", "pink", "plum", "powder",
                "puff", "purple", "red", "rose", "rosy", "royal", "saddle", "salmon",
                "sandy", "seashell", "sienna", "sky", "slate", "smoke", "snow", "spring",
                "steel", "tan", "thistle", "tomato", "turquoise", "violet", "wheat",
                "white", "yellow"]

_EPOCH_1992 = 8035   # days('1992-01-01')
_ORDER_DATE_RANGE = 2406  # through 1998-08-02

_COMMENT_WORDS = np.array(["carefully", "quickly", "furiously", "slyly", "blithely",
                           "final", "special", "pending", "regular", "express", "ironic",
                           "even", "bold", "silent", "dogged", "instructions", "requests",
                           "deposits", "packages", "accounts", "foxes", "ideas", "theodolites",
                           "pinto", "beans", "platelets", "asymptotes"])


def _comments(rng: np.random.Generator, n: int) -> List[str]:
    w = _COMMENT_WORDS[rng.integers(0, len(_COMMENT_WORDS), (n, 3))]
    return [" ".join(r) for r in w]


def generate(sf: float, seed: int = 19920101) -> Dict[str, Dict[str, list]]:
    """Generate all eight tables at scale factor `sf` as column dicts of Python values."""
    rng = np.random.default_rng(seed)
    out: Dict[str, Dict[str, list]] = {}

    out["region"] = {
        "r_regionkey": list(range(5)),
        "r_name": REGIONS,
        "r_comment": _comments(rng, 5),
    }
    out["nation"] = {
        "n_nationkey": list(range(25)),
        "n_name": [n for n, _ in NATIONS],
        "n_regionkey": [r for _, r in NATIONS],
        "n_comment": _comments(rng, 25),
    }

    n_supp = max(int(10_000 * sf), 50)
    supp_keys = np.arange(1, n_supp + 1)
    out["supplier"] = {
        "s_suppkey": supp_keys.tolist(),
        "s_name": [f"Supplier#{k:09d}" for k in supp_keys],
        "s_address": [f"addr{k}" for k in supp_keys],
        "s_nationkey": rng.integers(0, 25, n_supp).tolist(),
        "s_phone": [f"{10+k%25}-{k%900+100}-{k%9000+1000}" for k in supp_keys],
        "s_acctbal": np.round(rng.uniform(-999.99, 9999.99, n_supp), 2).tolist(),
        "s_comment": _comments(rng, n_supp),
    }

    n_part = max(int(200_000 * sf), 200)
    part_keys = np.arange(1, n_part + 1)
    name_ix = rng.integers(0, len(P_NAME_WORDS), (n_part, 5))
    mfgr = rng.integers(1, 6, n_part)
    brand = mfgr * 10 + rng.integers(1, 6, n_part)
    out["part"] = {
        "p_partkey": part_keys.tolist(),
        "p_name": [" ".join(P_NAME_WORDS[j] for j in row) for row in name_ix],
        "p_mfgr": [f"Manufacturer#{m}" for m in mfgr],
        "p_brand": [f"Brand#{b}" for b in brand],
        "p_type": [f"{TYPE_S1[a]} {TYPE_S2[b]} {TYPE_S3[c]}"
                   for a, b, c in zip(rng.integers(0, 6, n_part),
                                      rng.integers(0, 5, n_part),
                                      rng.integers(0, 5, n_part))],
        "p_size": rng.integers(1, 51, n_part).tolist(),
        "p_container": [f"{CONTAINERS1[a]} {CONTAINERS2[b]}"
                        for a, b in zip(rng.integers(0, 5, n_part),
                                        rng.integers(0, 8, n_part))],
        "p_retailprice": np.round(
            900 + (part_keys % 1000) / 10 + 100 * (part_keys % 10), 2).tolist(),
        "p_comment": _comments(rng, n_part),
    }

    n_ps = n_part * 4
    ps_part = np.repeat(part_keys, 4)
    ps_supp = np.zeros(n_ps, dtype=np.int64)
    for j in range(4):
        ps_supp[j::4] = (ps_part[j::4] + (j * (n_supp // 4 + (ps_part[j::4] - 1)
                                               % (n_supp // 4)))) % n_supp + 1
    out["partsupp"] = {
        "ps_partkey": ps_part.tolist(),
        "ps_suppkey": ps_supp.tolist(),
        "ps_availqty": rng.integers(1, 10_000, n_ps).tolist(),
        "ps_supplycost": np.round(rng.uniform(1.0, 1000.0, n_ps), 2).tolist(),
        "ps_comment": _comments(rng, n_ps),
    }

    n_cust = max(int(150_000 * sf), 150)
    cust_keys = np.arange(1, n_cust + 1)
    out["customer"] = {
        "c_custkey": cust_keys.tolist(),
        "c_name": [f"Customer#{k:09d}" for k in cust_keys],
        "c_address": [f"addr{k}" for k in cust_keys],
        "c_nationkey": rng.integers(0, 25, n_cust).tolist(),
        "c_phone": [f"{10+k%25}-{k%900+100}-{k%9000+1000}" for k in cust_keys],
        "c_acctbal": np.round(rng.uniform(-999.99, 9999.99, n_cust), 2).tolist(),
        "c_mktsegment": [SEGMENTS[i] for i in rng.integers(0, 5, n_cust)],
        "c_comment": _comments(rng, n_cust),
    }

    n_ord = n_cust * 10
    ord_keys = np.arange(1, n_ord + 1) * 4 - 3  # sparse keys like dbgen
    o_date = _EPOCH_1992 + rng.integers(0, _ORDER_DATE_RANGE, n_ord)
    # only ~2/3 of customers have orders (spec): map to custkey % 3 != 0
    o_cust = rng.integers(1, n_cust + 1, n_ord)
    o_cust = o_cust - (o_cust % 3 == 0)
    o_cust = np.where(o_cust == 0, 1, o_cust)
    out["orders"] = {
        "o_orderkey": ord_keys.tolist(),
        "o_custkey": o_cust.tolist(),
        "o_orderstatus": ["F"] * n_ord,  # fixed after lineitem below
        "o_totalprice": np.zeros(n_ord).tolist(),
        "o_orderdate": o_date.tolist(),
        "o_orderpriority": [PRIORITIES[i] for i in rng.integers(0, 5, n_ord)],
        "o_clerk": [f"Clerk#{i:09d}" for i in rng.integers(1, max(int(sf * 1000), 10),
                                                           n_ord)],
        "o_shippriority": [0] * n_ord,
        "o_comment": _comments(rng, n_ord),
    }

    # lineitem: 1-7 lines per order
    lines_per = rng.integers(1, 8, n_ord)
    n_li = int(lines_per.sum())
    li_order = np.repeat(ord_keys, lines_per)
    li_odate = np.repeat(o_date, lines_per)
    li_lineno = np.concatenate([np.arange(1, c + 1) for c in lines_per])
    l_part = rng.integers(1, n_part + 1, n_li)
    l_supp = ((l_part + rng.integers(0, 4, n_li) * (n_supp // 4 + 1)) % n_supp) + 1
    qty = rng.integers(1, 51, n_li)
    retail = 900 + (l_part % 1000) / 10 + 100 * (l_part % 10)
    eprice = np.round(qty * retail, 2)
    ship = li_odate + rng.integers(1, 122, n_li)
    commit = li_odate + rng.integers(30, 91, n_li)
    receipt = ship + rng.integers(1, 31, n_li)
    today = _EPOCH_1992 + 1839  # 1995-06-17 per spec currentdate
    rflag = np.where(receipt <= today,
                     np.where(rng.random(n_li) < 0.5, "R", "A"), "N")
    lstatus = np.where(ship > today, "O", "F")
    out["lineitem"] = {
        "l_orderkey": li_order.tolist(),
        "l_partkey": l_part.tolist(),
        "l_suppkey": l_supp.tolist(),
        "l_linenumber": li_lineno.tolist(),
        "l_quantity": qty.astype(float).tolist(),
        "l_extendedprice": eprice.tolist(),
        "l_discount": np.round(rng.integers(0, 11, n_li) / 100, 2).tolist(),
        "l_tax": np.round(rng.integers(0, 9, n_li) / 100, 2).tolist(),
        "l_returnflag": rflag.tolist(),
        "l_linestatus": lstatus.tolist(),
        "l_shipdate": ship.tolist(),
        "l_commitdate": commit.tolist(),
        "l_receiptdate": receipt.tolist(),
        "l_shipinstruct": [SHIPINSTRUCT[i] for i in rng.integers(0, 4, n_li)],
        "l_shipmode": [SHIPMODES[i] for i in rng.integers(0, 7, n_li)],
        "l_comment": _comments(rng, n_li),
    }

    # orders.o_orderstatus consistency: F if all lines F, O if all O, else P
    import collections
    status_by_order: Dict[int, set] = collections.defaultdict(set)
    for k, s in zip(li_order.tolist(), lstatus.tolist()):
        status_by_order[k].add(s)
    o_status = []
    totals = collections.defaultdict(float)
    for k, p in zip(li_order.tolist(), eprice.tolist()):
        totals[k] += p
    for k in ord_keys.tolist():
        st = status_by_order.get(k)
        if not st:
            o_status.append("O")
        elif st == {"F"}:
            o_status.append("F")
        elif st == {"O"}:
            o_status.append("O")
        else:
            o_status.append("P")
    out["orders"]["o_orderstatus"] = o_status
    out["orders"]["o_totalprice"] = [round(totals.get(k, 0.0), 2)
                                     for k in ord_keys.tolist()]
    return out
