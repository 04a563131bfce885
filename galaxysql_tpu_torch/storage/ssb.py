"""Star Schema Benchmark: schema, generator, and the 13 queries (public SSB spec).

BASELINE.md config 4: wide fact scan + broadcast dimension joins — the shape the
broadcast-join path of the MPP engine exists for.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from galaxysql_tpu_torch.storage.tpch import REGIONS, NATIONS, _comments

SSB_DDL = {
    "dates": """
        CREATE TABLE dates (
            d_datekey INT NOT NULL PRIMARY KEY,
            d_date VARCHAR(18), d_dayofweek VARCHAR(9), d_month VARCHAR(9),
            d_year INT, d_yearmonthnum INT, d_yearmonth VARCHAR(7),
            d_weeknuminyear INT
        ) BROADCAST
    """,
    "supplier": """
        CREATE TABLE supplier (
            s_suppkey INT NOT NULL PRIMARY KEY, s_name VARCHAR(25),
            s_address VARCHAR(25), s_city VARCHAR(10), s_nation VARCHAR(15),
            s_region VARCHAR(12), s_phone VARCHAR(15)
        ) BROADCAST
    """,
    "customer": """
        CREATE TABLE customer (
            c_custkey INT NOT NULL PRIMARY KEY, c_name VARCHAR(25),
            c_address VARCHAR(25), c_city VARCHAR(10), c_nation VARCHAR(15),
            c_region VARCHAR(12), c_phone VARCHAR(15), c_mktsegment VARCHAR(10)
        ) PARTITION BY HASH(c_custkey) PARTITIONS 8
    """,
    "part": """
        CREATE TABLE part (
            p_partkey INT NOT NULL PRIMARY KEY, p_name VARCHAR(22),
            p_mfgr VARCHAR(6), p_category VARCHAR(7), p_brand1 VARCHAR(9),
            p_color VARCHAR(11), p_type VARCHAR(25), p_size INT,
            p_container VARCHAR(10)
        ) BROADCAST
    """,
    "lineorder": """
        CREATE TABLE lineorder (
            lo_orderkey BIGINT NOT NULL, lo_linenumber INT NOT NULL,
            lo_custkey INT NOT NULL, lo_partkey INT NOT NULL,
            lo_suppkey INT NOT NULL, lo_orderdate INT NOT NULL,
            lo_orderpriority VARCHAR(15), lo_shippriority INT,
            lo_quantity INT, lo_extendedprice BIGINT, lo_ordtotalprice BIGINT,
            lo_discount INT, lo_revenue BIGINT, lo_supplycost BIGINT,
            lo_tax INT, lo_commitdate INT, lo_shipmode VARCHAR(10),
            PRIMARY KEY (lo_orderkey, lo_linenumber)
        ) PARTITION BY HASH(lo_orderkey) PARTITIONS 8
    """,
}

TABLE_ORDER = ["dates", "supplier", "customer", "part", "lineorder"]

_MONTHS = ["January", "February", "March", "April", "May", "June", "July",
           "August", "September", "October", "November", "December"]
_DOW = ["Monday", "Tuesday", "Wednesday", "Thursday", "Friday", "Saturday", "Sunday"]
_COLORS = ["red", "green", "blue", "pink", "azure", "ivory", "linen", "navy",
           "peru", "plum", "puff", "snow"]
_CITY_N = 10


def generate(sf: float, seed: int = 19980101) -> Dict[str, Dict[str, list]]:
    rng = np.random.default_rng(seed)
    out: Dict[str, Dict[str, list]] = {}

    # dates: 1992-01-01 .. 1998-12-31 (datekey = yyyymmdd)
    import datetime
    day = datetime.date(1992, 1, 1)
    end = datetime.date(1998, 12, 31)
    keys, dstr, dow, mon, yr, ymn, ym, wk = [], [], [], [], [], [], [], []
    while day <= end:
        keys.append(day.year * 10000 + day.month * 100 + day.day)
        dstr.append(day.isoformat())
        dow.append(_DOW[day.weekday()])
        mon.append(_MONTHS[day.month - 1])
        yr.append(day.year)
        ymn.append(day.year * 100 + day.month)
        ym.append(f"{_MONTHS[day.month - 1][:3]}{day.year}")
        wk.append(int(day.isocalendar()[1]))
        day += datetime.timedelta(days=1)
    out["dates"] = {"d_datekey": keys, "d_date": dstr, "d_dayofweek": dow,
                    "d_month": mon, "d_year": yr, "d_yearmonthnum": ymn,
                    "d_yearmonth": ym, "d_weeknuminyear": wk}

    nations = [n for n, _ in NATIONS]
    region_of = {n: REGIONS[r].replace(" ", "") for n, r in NATIONS}

    def geo(n):
        nat = [nations[i] for i in rng.integers(0, len(nations), n)]
        city = [f"{x[:9]}{rng.integers(0, _CITY_N)}" for x in nat]
        reg = [region_of[x] for x in nat]
        return nat, city, reg

    n_supp = max(int(2_000 * sf), 20)
    sk = np.arange(1, n_supp + 1)
    nat, city, reg = geo(n_supp)
    out["supplier"] = {
        "s_suppkey": sk.tolist(), "s_name": [f"Supplier#{k:09d}" for k in sk],
        "s_address": [f"addr{k}" for k in sk], "s_city": city, "s_nation": nat,
        "s_region": reg, "s_phone": [f"{k % 25}-{k % 900 + 100}" for k in sk]}

    n_cust = max(int(30_000 * sf), 60)
    ck = np.arange(1, n_cust + 1)
    nat, city, reg = geo(n_cust)
    out["customer"] = {
        "c_custkey": ck.tolist(), "c_name": [f"Customer#{k:09d}" for k in ck],
        "c_address": [f"addr{k}" for k in ck], "c_city": city, "c_nation": nat,
        "c_region": reg, "c_phone": [f"{k % 25}-{k % 900 + 100}" for k in ck],
        "c_mktsegment": ["AUTOMOBILE"] * n_cust}

    n_part = max(int(200_000 * min(sf, 1) ** 0.5 * 0.2), 200)
    pk = np.arange(1, n_part + 1)
    mfgr = rng.integers(1, 6, n_part)
    cat = mfgr * 10 + rng.integers(1, 6, n_part)
    brand = cat * 100 + rng.integers(1, 41, n_part)
    out["part"] = {
        "p_partkey": pk.tolist(), "p_name": [f"part{k}" for k in pk],
        "p_mfgr": [f"MFGR#{m}" for m in mfgr],
        "p_category": [f"MFGR#{c}" for c in cat],
        "p_brand1": [f"MFGR#{b}" for b in brand],
        "p_color": [_COLORS[i] for i in rng.integers(0, len(_COLORS), n_part)],
        "p_type": [f"type{i}" for i in rng.integers(0, 25, n_part)],
        "p_size": rng.integers(1, 51, n_part).tolist(),
        "p_container": ["SM BOX"] * n_part}

    n_lo = max(int(6_000_000 * sf), 1000)
    lo_key = np.arange(1, n_lo + 1)
    odate = np.asarray(out["dates"]["d_datekey"])[
        rng.integers(0, len(keys), n_lo)]
    qty = rng.integers(1, 51, n_lo)
    price = rng.integers(90_000, 10_000_000, n_lo)
    disc = rng.integers(0, 11, n_lo)
    out["lineorder"] = {
        "lo_orderkey": lo_key.tolist(),
        "lo_linenumber": np.ones(n_lo, dtype=np.int64).tolist(),
        "lo_custkey": rng.integers(1, n_cust + 1, n_lo).tolist(),
        "lo_partkey": rng.integers(1, n_part + 1, n_lo).tolist(),
        "lo_suppkey": rng.integers(1, n_supp + 1, n_lo).tolist(),
        "lo_orderdate": odate.tolist(),
        "lo_orderpriority": ["1-URGENT"] * n_lo,
        "lo_shippriority": [0] * n_lo,
        "lo_quantity": qty.tolist(),
        "lo_extendedprice": price.tolist(),
        "lo_ordtotalprice": (price * 3).tolist(),
        "lo_discount": disc.tolist(),
        "lo_revenue": (price * (100 - disc) // 100).tolist(),
        "lo_supplycost": (price * 6 // 10).tolist(),
        "lo_tax": rng.integers(0, 9, n_lo).tolist(),
        "lo_commitdate": odate.tolist(),
        "lo_shipmode": ["TRUCK"] * n_lo}
    return out


QUERIES = {
    "1.1": """SELECT sum(lo_extendedprice * lo_discount) AS revenue
              FROM lineorder, dates WHERE lo_orderdate = d_datekey
              AND d_year = 1993 AND lo_discount BETWEEN 1 AND 3
              AND lo_quantity < 25""",
    "1.2": """SELECT sum(lo_extendedprice * lo_discount) AS revenue
              FROM lineorder, dates WHERE lo_orderdate = d_datekey
              AND d_yearmonthnum = 199401 AND lo_discount BETWEEN 4 AND 6
              AND lo_quantity BETWEEN 26 AND 35""",
    "1.3": """SELECT sum(lo_extendedprice * lo_discount) AS revenue
              FROM lineorder, dates WHERE lo_orderdate = d_datekey
              AND d_weeknuminyear = 6 AND d_year = 1994
              AND lo_discount BETWEEN 5 AND 7 AND lo_quantity BETWEEN 26 AND 35""",
    "2.1": """SELECT sum(lo_revenue) AS r, d_year, p_brand1
              FROM lineorder, dates, part, supplier
              WHERE lo_orderdate = d_datekey AND lo_partkey = p_partkey
              AND lo_suppkey = s_suppkey AND p_category = 'MFGR#12'
              AND s_region = 'AMERICA'
              GROUP BY d_year, p_brand1 ORDER BY d_year, p_brand1""",
    "2.2": """SELECT sum(lo_revenue) AS r, d_year, p_brand1
              FROM lineorder, dates, part, supplier
              WHERE lo_orderdate = d_datekey AND lo_partkey = p_partkey
              AND lo_suppkey = s_suppkey
              AND p_brand1 BETWEEN 'MFGR#2221' AND 'MFGR#2228'
              AND s_region = 'ASIA'
              GROUP BY d_year, p_brand1 ORDER BY d_year, p_brand1""",
    "2.3": """SELECT sum(lo_revenue) AS r, d_year, p_brand1
              FROM lineorder, dates, part, supplier
              WHERE lo_orderdate = d_datekey AND lo_partkey = p_partkey
              AND lo_suppkey = s_suppkey AND p_brand1 = 'MFGR#2239'
              AND s_region = 'EUROPE'
              GROUP BY d_year, p_brand1 ORDER BY d_year, p_brand1""",
    "3.1": """SELECT c_nation, s_nation, d_year, sum(lo_revenue) AS r
              FROM customer, lineorder, supplier, dates
              WHERE lo_custkey = c_custkey AND lo_suppkey = s_suppkey
              AND lo_orderdate = d_datekey AND c_region = 'ASIA'
              AND s_region = 'ASIA' AND d_year >= 1992 AND d_year <= 1997
              GROUP BY c_nation, s_nation, d_year
              ORDER BY d_year, r DESC""",
    "3.2": """SELECT c_city, s_city, d_year, sum(lo_revenue) AS r
              FROM customer, lineorder, supplier, dates
              WHERE lo_custkey = c_custkey AND lo_suppkey = s_suppkey
              AND lo_orderdate = d_datekey AND c_nation = 'UNITED STATES'
              AND s_nation = 'UNITED STATES'
              AND d_year >= 1992 AND d_year <= 1997
              GROUP BY c_city, s_city, d_year ORDER BY d_year, r DESC""",
    "3.3": """SELECT c_city, s_city, d_year, sum(lo_revenue) AS r
              FROM customer, lineorder, supplier, dates
              WHERE lo_custkey = c_custkey AND lo_suppkey = s_suppkey
              AND lo_orderdate = d_datekey
              AND (c_city = 'UNITED KI1' OR c_city = 'UNITED KI5')
              AND (s_city = 'UNITED KI1' OR s_city = 'UNITED KI5')
              AND d_year >= 1992 AND d_year <= 1997
              GROUP BY c_city, s_city, d_year ORDER BY d_year, r DESC""",
    "3.4": """SELECT c_city, s_city, d_year, sum(lo_revenue) AS r
              FROM customer, lineorder, supplier, dates
              WHERE lo_custkey = c_custkey AND lo_suppkey = s_suppkey
              AND lo_orderdate = d_datekey
              AND (c_city = 'UNITED KI1' OR c_city = 'UNITED KI5')
              AND (s_city = 'UNITED KI1' OR s_city = 'UNITED KI5')
              AND d_yearmonth = 'Dec1997'
              GROUP BY c_city, s_city, d_year ORDER BY d_year, r DESC""",
    "4.1": """SELECT d_year, c_nation, sum(lo_revenue - lo_supplycost) AS profit
              FROM dates, customer, supplier, part, lineorder
              WHERE lo_custkey = c_custkey AND lo_suppkey = s_suppkey
              AND lo_partkey = p_partkey AND lo_orderdate = d_datekey
              AND c_region = 'AMERICA' AND s_region = 'AMERICA'
              AND (p_mfgr = 'MFGR#1' OR p_mfgr = 'MFGR#2')
              GROUP BY d_year, c_nation ORDER BY d_year, c_nation""",
    "4.2": """SELECT d_year, s_nation, p_category,
              sum(lo_revenue - lo_supplycost) AS profit
              FROM dates, customer, supplier, part, lineorder
              WHERE lo_custkey = c_custkey AND lo_suppkey = s_suppkey
              AND lo_partkey = p_partkey AND lo_orderdate = d_datekey
              AND c_region = 'AMERICA' AND s_region = 'AMERICA'
              AND (d_year = 1997 OR d_year = 1998)
              AND (p_mfgr = 'MFGR#1' OR p_mfgr = 'MFGR#2')
              GROUP BY d_year, s_nation, p_category
              ORDER BY d_year, s_nation, p_category""",
    "4.3": """SELECT d_year, s_city, p_brand1,
              sum(lo_revenue - lo_supplycost) AS profit
              FROM dates, customer, supplier, part, lineorder
              WHERE lo_custkey = c_custkey AND lo_suppkey = s_suppkey
              AND lo_partkey = p_partkey AND lo_orderdate = d_datekey
              AND s_nation = 'UNITED STATES' AND (d_year = 1997 OR d_year = 1998)
              AND p_category = 'MFGR#14'
              GROUP BY d_year, s_city, p_brand1
              ORDER BY d_year, s_city, p_brand1""",
}
