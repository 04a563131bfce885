"""TPC-DS subset: schema, data generator, and a 10-query suite (BASELINE config #5).

Reference analog: the TPC-DS planner golden suite (`planner/tpcds/TpcdsPlanTest.java`,
SURVEY.md §4).  Queries are the official texts of q3/q7/q19/q22/q27/q42/q52/q55/q96/q59
lightly adapted to the supported grammar (no syntax changes beyond alias style).  The
generator follows the same approach as `tpch.py`: uniform draws over the spec's value
domains with SF-scaled cardinalities — representative for engine testing, not audited
TPC-DS publication.  Dates are epoch-day ints; decimals are floats at insert time
(encoded to scaled int64 lanes by the DECIMAL column types).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from galaxysql_tpu_torch.types import temporal

TPCDS_DDL = {
    "date_dim": """
        CREATE TABLE date_dim (
            d_date_sk   INT NOT NULL PRIMARY KEY,
            d_date      DATE NOT NULL,
            d_year      INT NOT NULL,
            d_moy       INT NOT NULL,
            d_dom       INT NOT NULL,
            d_qoy       INT NOT NULL,
            d_week_seq  INT NOT NULL,
            d_month_seq INT NOT NULL,
            d_day_name  VARCHAR(9) NOT NULL
        ) BROADCAST
    """,
    "time_dim": """
        CREATE TABLE time_dim (
            t_time_sk INT NOT NULL PRIMARY KEY,
            t_hour    INT NOT NULL,
            t_minute  INT NOT NULL
        ) BROADCAST
    """,
    "item": """
        CREATE TABLE item (
            i_item_sk      INT NOT NULL PRIMARY KEY,
            i_item_id      VARCHAR(16) NOT NULL,
            i_brand_id     INT,
            i_brand        VARCHAR(50),
            i_class_id     INT,
            i_class        VARCHAR(50),
            i_category_id  INT,
            i_category     VARCHAR(50),
            i_manufact_id  INT,
            i_manufact     VARCHAR(50),
            i_manager_id   INT,
            i_product_name VARCHAR(50),
            i_current_price DECIMAL(7,2)
        ) PARTITION BY HASH(i_item_sk) PARTITIONS 4
    """,
    "customer": """
        CREATE TABLE customer (
            c_customer_sk      INT NOT NULL PRIMARY KEY,
            c_customer_id      VARCHAR(16) NOT NULL,
            c_current_cdemo_sk INT,
            c_current_addr_sk  INT,
            c_first_name       VARCHAR(20),
            c_last_name        VARCHAR(30)
        ) PARTITION BY HASH(c_customer_sk) PARTITIONS 4
    """,
    "customer_address": """
        CREATE TABLE customer_address (
            ca_address_sk INT NOT NULL PRIMARY KEY,
            ca_state      VARCHAR(2),
            ca_zip        VARCHAR(10),
            ca_county     VARCHAR(30),
            ca_country    VARCHAR(20)
        ) PARTITION BY HASH(ca_address_sk) PARTITIONS 4
    """,
    "customer_demographics": """
        CREATE TABLE customer_demographics (
            cd_demo_sk          INT NOT NULL PRIMARY KEY,
            cd_gender           VARCHAR(1),
            cd_marital_status   VARCHAR(1),
            cd_education_status VARCHAR(20),
            cd_dep_count        INT
        ) BROADCAST
    """,
    "household_demographics": """
        CREATE TABLE household_demographics (
            hd_demo_sk      INT NOT NULL PRIMARY KEY,
            hd_dep_count    INT,
            hd_vehicle_count INT
        ) BROADCAST
    """,
    "store": """
        CREATE TABLE store (
            s_store_sk    INT NOT NULL PRIMARY KEY,
            s_store_id    VARCHAR(16) NOT NULL,
            s_store_name  VARCHAR(50),
            s_number_employees INT,
            s_state       VARCHAR(2),
            s_zip         VARCHAR(10),
            s_county      VARCHAR(30)
        ) BROADCAST
    """,
    "promotion": """
        CREATE TABLE promotion (
            p_promo_sk      INT NOT NULL PRIMARY KEY,
            p_channel_dmail VARCHAR(1),
            p_channel_email VARCHAR(1),
            p_channel_event VARCHAR(1),
            p_channel_tv    VARCHAR(1)
        ) BROADCAST
    """,
    "warehouse": """
        CREATE TABLE warehouse (
            w_warehouse_sk   INT NOT NULL PRIMARY KEY,
            w_warehouse_name VARCHAR(20)
        ) BROADCAST
    """,
    "inventory": """
        CREATE TABLE inventory (
            inv_date_sk          INT NOT NULL,
            inv_item_sk          INT NOT NULL,
            inv_warehouse_sk     INT NOT NULL,
            inv_quantity_on_hand INT
        ) PARTITION BY HASH(inv_item_sk) PARTITIONS 4
    """,
    "store_sales": """
        CREATE TABLE store_sales (
            ss_sold_date_sk   INT,
            ss_sold_time_sk   INT,
            ss_item_sk        INT NOT NULL,
            ss_customer_sk    INT,
            ss_cdemo_sk       INT,
            ss_hdemo_sk       INT,
            ss_addr_sk        INT,
            ss_store_sk       INT,
            ss_promo_sk       INT,
            ss_quantity       INT,
            ss_list_price     DECIMAL(7,2),
            ss_sales_price    DECIMAL(7,2),
            ss_ext_sales_price DECIMAL(7,2),
            ss_ext_discount_amt DECIMAL(7,2),
            ss_coupon_amt     DECIMAL(7,2),
            ss_net_profit     DECIMAL(7,2)
        ) PARTITION BY HASH(ss_item_sk) PARTITIONS 8
    """,
}

TABLE_ORDER = ["date_dim", "time_dim", "item", "customer", "customer_address",
               "customer_demographics", "household_demographics", "store",
               "promotion", "warehouse", "inventory", "store_sales"]

_DAY_NAMES = ["Sunday", "Monday", "Tuesday", "Wednesday", "Thursday", "Friday",
              "Saturday"]
_STATES = ["TN", "SD", "AL", "GA", "OH", "TX", "CA", "WA"]
_CATEGORIES = ["Books", "Home", "Electronics", "Jewelry", "Sports", "Music",
               "Women", "Men", "Children", "Shoes"]
_EDU = ["College", "2 yr Degree", "4 yr Degree", "Advanced Degree", "Primary",
        "Secondary", "Unknown"]


def generate(sf: float, seed: int = 20030101) -> Dict[str, Dict[str, list]]:
    """All twelve tables at scale factor `sf` as column dicts of Python values."""
    rng = np.random.default_rng(seed)
    out: Dict[str, Dict[str, list]] = {}

    # date_dim: calendar 1998-01-01 .. 2002-12-31 (the window the queries hit)
    d0 = temporal.parse_date("1998-01-01")
    d1 = temporal.parse_date("2002-12-31")
    days = np.arange(d0, d1 + 1)
    ymd = [temporal.civil_from_days(int(d)) for d in days]
    years = np.array([y for y, _m, _d in ymd])
    moys = np.array([m for _y, m, _d in ymd])
    doms = np.array([d for _y, _m, d in ymd])
    # TPC-DS d_date_sk base is 2415022 (julian-ish); keep small consecutive sks
    sks = np.arange(len(days)) + 2450815
    out["date_dim"] = {
        "d_date_sk": sks.tolist(),
        "d_date": days.tolist(),
        "d_year": years.tolist(),
        "d_moy": moys.tolist(),
        "d_dom": doms.tolist(),
        "d_qoy": ((moys - 1) // 3 + 1).tolist(),
        "d_week_seq": ((days - d0) // 7 + 5000).tolist(),
        "d_month_seq": ((years - 1900) * 12 + moys - 1).tolist(),
        "d_day_name": [_DAY_NAMES[int(d + 4) % 7] for d in days],  # 1998-01-01 = Thu
    }
    date_sks = sks

    n_time = 1440
    out["time_dim"] = {
        "t_time_sk": list(range(n_time)),
        "t_hour": [t // 60 for t in range(n_time)],
        "t_minute": [t % 60 for t in range(n_time)],
    }

    n_item = max(int(18000 * sf), 200)
    brands = rng.integers(1, 1000, n_item)
    cats = rng.integers(0, len(_CATEGORIES), n_item)
    classes = rng.integers(1, 100, n_item)
    out["item"] = {
        "i_item_sk": list(range(1, n_item + 1)),
        "i_item_id": [f"ITEM{k:012d}"[:16] for k in rng.integers(0, n_item // 2 + 1, n_item)],
        "i_brand_id": brands.tolist(),
        "i_brand": [f"brand#{b}" for b in brands],
        "i_class_id": classes.tolist(),
        "i_class": [f"class{c}" for c in classes],
        "i_category_id": (cats + 1).tolist(),
        "i_category": [_CATEGORIES[c] for c in cats],
        "i_manufact_id": rng.integers(1, 200, n_item).tolist(),
        "i_manufact": [f"manu#{m}" for m in rng.integers(1, 100, n_item)],
        "i_manager_id": rng.integers(1, 40, n_item).tolist(),
        "i_product_name": [f"prod{p}" for p in rng.integers(1, n_item // 4 + 2, n_item)],
        "i_current_price": np.round(rng.uniform(0.5, 100, n_item), 2).tolist(),
    }

    n_cust = max(int(100_000 * sf), 500)
    n_addr = max(n_cust // 2, 250)
    n_cd = 720
    n_hd = 144
    out["customer"] = {
        "c_customer_sk": list(range(1, n_cust + 1)),
        "c_customer_id": [f"CUST{k:012d}"[:16] for k in range(1, n_cust + 1)],
        "c_current_cdemo_sk": rng.integers(1, n_cd + 1, n_cust).tolist(),
        "c_current_addr_sk": rng.integers(1, n_addr + 1, n_cust).tolist(),
        "c_first_name": [f"fn{k}" for k in rng.integers(0, 500, n_cust)],
        "c_last_name": [f"ln{k}" for k in rng.integers(0, 700, n_cust)],
    }
    out["customer_address"] = {
        "ca_address_sk": list(range(1, n_addr + 1)),
        "ca_state": [_STATES[k] for k in rng.integers(0, len(_STATES), n_addr)],
        "ca_zip": [f"{z:05d}" for z in rng.integers(10000, 99999, n_addr)],
        "ca_county": [f"county{k}" for k in rng.integers(0, 30, n_addr)],
        "ca_country": ["United States"] * n_addr,
    }
    out["customer_demographics"] = {
        "cd_demo_sk": list(range(1, n_cd + 1)),
        "cd_gender": [("M", "F")[k % 2] for k in range(n_cd)],
        "cd_marital_status": ["SMDWU"[k // 2 % 5] for k in range(n_cd)],
        "cd_education_status": [_EDU[k // 10 % len(_EDU)] for k in range(n_cd)],
        "cd_dep_count": [k % 7 for k in range(n_cd)],
    }
    out["household_demographics"] = {
        "hd_demo_sk": list(range(1, n_hd + 1)),
        "hd_dep_count": [k % 10 for k in range(n_hd)],
        "hd_vehicle_count": [k % 5 for k in range(n_hd)],
    }

    n_store = 12
    out["store"] = {
        "s_store_sk": list(range(1, n_store + 1)),
        "s_store_id": [f"ST{k:014d}"[:16] for k in range(1, n_store + 1)],
        "s_store_name": [("ese", "ought", "able", "bar")[k % 4]
                         for k in range(n_store)],
        "s_number_employees": rng.integers(200, 300, n_store).tolist(),
        "s_state": [_STATES[k % len(_STATES)] for k in range(n_store)],
        "s_zip": [f"{z:05d}" for z in rng.integers(10000, 99999, n_store)],
        "s_county": [f"county{k % 30}" for k in range(n_store)],
    }
    n_promo = 300
    yn = np.array(["Y", "N"])
    out["promotion"] = {
        "p_promo_sk": list(range(1, n_promo + 1)),
        "p_channel_dmail": yn[rng.integers(0, 2, n_promo)].tolist(),
        "p_channel_email": yn[rng.integers(0, 2, n_promo)].tolist(),
        "p_channel_event": yn[rng.integers(0, 2, n_promo)].tolist(),
        "p_channel_tv": yn[rng.integers(0, 2, n_promo)].tolist(),
    }

    n_wh = 5
    out["warehouse"] = {
        "w_warehouse_sk": list(range(1, n_wh + 1)),
        "w_warehouse_name": [f"wh{k}" for k in range(1, n_wh + 1)],
    }
    n_inv = max(int(sf * 200_000), 5000)
    out["inventory"] = {
        "inv_date_sk": rng.choice(date_sks, n_inv).tolist(),
        "inv_item_sk": rng.integers(1, n_item + 1, n_inv).tolist(),
        "inv_warehouse_sk": rng.integers(1, n_wh + 1, n_inv).tolist(),
        "inv_quantity_on_hand": rng.integers(0, 1000, n_inv).tolist(),
    }

    n_ss = max(int(sf * 2_880_000), 20_000)
    qty = rng.integers(1, 101, n_ss)
    list_price = np.round(rng.uniform(1, 200, n_ss), 2)
    sales_price = np.round(list_price * rng.uniform(0.2, 1.0, n_ss), 2)
    ext_sales = np.round(sales_price * qty, 2)
    out["store_sales"] = {
        "ss_sold_date_sk": rng.choice(date_sks, n_ss).tolist(),
        "ss_sold_time_sk": rng.integers(0, n_time, n_ss).tolist(),
        "ss_item_sk": rng.integers(1, n_item + 1, n_ss).tolist(),
        "ss_customer_sk": rng.integers(1, n_cust + 1, n_ss).tolist(),
        "ss_cdemo_sk": rng.integers(1, n_cd + 1, n_ss).tolist(),
        "ss_hdemo_sk": rng.integers(1, n_hd + 1, n_ss).tolist(),
        "ss_addr_sk": rng.integers(1, n_addr + 1, n_ss).tolist(),
        "ss_store_sk": rng.integers(1, n_store + 1, n_ss).tolist(),
        "ss_promo_sk": rng.integers(1, n_promo + 1, n_ss).tolist(),
        "ss_quantity": qty.tolist(),
        "ss_list_price": list_price.tolist(),
        "ss_sales_price": sales_price.tolist(),
        "ss_ext_sales_price": ext_sales.tolist(),
        "ss_ext_discount_amt": np.round((list_price - sales_price) * qty, 2).tolist(),
        "ss_coupon_amt": np.round(rng.uniform(0, 20, n_ss), 2).tolist(),
        "ss_net_profit": np.round(ext_sales * rng.uniform(-0.1, 0.4, n_ss), 2).tolist(),
    }
    return out


QUERIES: Dict[str, str] = {
    "q3": """
        SELECT d_year, i_brand_id, i_brand, sum(ss_ext_sales_price) AS sum_agg
        FROM date_dim, store_sales, item
        WHERE d_date_sk = ss_sold_date_sk AND ss_item_sk = i_item_sk
          AND i_manufact_id = 128 AND d_moy = 11
        GROUP BY d_year, i_brand, i_brand_id
        ORDER BY d_year, sum_agg DESC, i_brand_id LIMIT 100
    """,
    "q7": """
        SELECT i_item_id, avg(ss_quantity) AS agg1, avg(ss_list_price) AS agg2,
               avg(ss_coupon_amt) AS agg3, avg(ss_sales_price) AS agg4
        FROM store_sales, customer_demographics, date_dim, item, promotion
        WHERE ss_sold_date_sk = d_date_sk AND ss_item_sk = i_item_sk
          AND ss_cdemo_sk = cd_demo_sk AND ss_promo_sk = p_promo_sk
          AND cd_gender = 'M' AND cd_marital_status = 'S'
          AND cd_education_status = 'College'
          AND (p_channel_email = 'N' OR p_channel_event = 'N') AND d_year = 2000
        GROUP BY i_item_id ORDER BY i_item_id LIMIT 100
    """,
    "q19": """
        SELECT i_brand_id, i_brand, i_manufact_id, i_manufact,
               sum(ss_ext_sales_price) AS ext_price
        FROM date_dim, store_sales, item, customer, customer_address, store
        WHERE d_date_sk = ss_sold_date_sk AND ss_item_sk = i_item_sk
          AND i_manager_id = 8 AND d_moy = 11 AND d_year = 1998
          AND ss_customer_sk = c_customer_sk AND c_current_addr_sk = ca_address_sk
          AND ss_store_sk = s_store_sk
          AND substr(ca_zip, 1, 5) <> substr(s_zip, 1, 5)
        GROUP BY i_brand, i_brand_id, i_manufact_id, i_manufact
        ORDER BY ext_price DESC, i_brand, i_brand_id, i_manufact_id, i_manufact
        LIMIT 100
    """,
    "q22": """
        SELECT i_product_name, i_brand, i_class, i_category,
               avg(inv_quantity_on_hand) AS qoh
        FROM inventory, date_dim, item
        WHERE inv_date_sk = d_date_sk AND inv_item_sk = i_item_sk
          AND d_month_seq BETWEEN 1200 AND 1211
        GROUP BY ROLLUP(i_product_name, i_brand, i_class, i_category)
        ORDER BY qoh, i_product_name, i_brand, i_class, i_category LIMIT 100
    """,
    "q27": """
        SELECT i_item_id, s_state, avg(ss_quantity) AS agg1,
               avg(ss_list_price) AS agg2, avg(ss_coupon_amt) AS agg3,
               avg(ss_sales_price) AS agg4
        FROM store_sales, customer_demographics, date_dim, store, item
        WHERE ss_sold_date_sk = d_date_sk AND ss_item_sk = i_item_sk
          AND ss_store_sk = s_store_sk AND ss_cdemo_sk = cd_demo_sk
          AND cd_gender = 'M' AND cd_marital_status = 'S'
          AND cd_education_status = 'College' AND d_year = 2002
          AND s_state IN ('TN', 'SD')
        GROUP BY ROLLUP(i_item_id, s_state)
        ORDER BY i_item_id, s_state LIMIT 100
    """,
    "q42": """
        SELECT d_year, i_category_id, i_category, sum(ss_ext_sales_price) AS s
        FROM date_dim, store_sales, item
        WHERE d_date_sk = ss_sold_date_sk AND ss_item_sk = i_item_sk
          AND i_manager_id = 1 AND d_moy = 11 AND d_year = 2000
        GROUP BY d_year, i_category_id, i_category
        ORDER BY s DESC, d_year, i_category_id, i_category LIMIT 100
    """,
    "q52": """
        SELECT d_year, i_brand_id, i_brand, sum(ss_ext_sales_price) AS ext_price
        FROM date_dim, store_sales, item
        WHERE d_date_sk = ss_sold_date_sk AND ss_item_sk = i_item_sk
          AND i_manager_id = 1 AND d_moy = 11 AND d_year = 2000
        GROUP BY d_year, i_brand, i_brand_id
        ORDER BY d_year, ext_price DESC, i_brand_id LIMIT 100
    """,
    "q55": """
        SELECT i_brand_id, i_brand, sum(ss_ext_sales_price) AS ext_price
        FROM date_dim, store_sales, item
        WHERE d_date_sk = ss_sold_date_sk AND ss_item_sk = i_item_sk
          AND i_manager_id = 28 AND d_moy = 11 AND d_year = 1999
        GROUP BY i_brand, i_brand_id
        ORDER BY ext_price DESC, i_brand_id LIMIT 100
    """,
    "q96": """
        SELECT count(*) AS cnt
        FROM store_sales, household_demographics, time_dim, store
        WHERE ss_sold_time_sk = t_time_sk AND ss_hdemo_sk = hd_demo_sk
          AND ss_store_sk = s_store_sk AND t_hour = 20 AND t_minute >= 30
          AND hd_dep_count = 7 AND s_store_name = 'ese'
    """,
    "q59": """
        WITH wss AS (
            SELECT d_week_seq, ss_store_sk,
                sum(CASE WHEN d_day_name = 'Sunday' THEN ss_sales_price
                    ELSE NULL END) AS sun_sales,
                sum(CASE WHEN d_day_name = 'Monday' THEN ss_sales_price
                    ELSE NULL END) AS mon_sales,
                sum(CASE WHEN d_day_name = 'Friday' THEN ss_sales_price
                    ELSE NULL END) AS fri_sales
            FROM store_sales, date_dim
            WHERE d_date_sk = ss_sold_date_sk
            GROUP BY d_week_seq, ss_store_sk)
        SELECT y.s_store_name1, y.s_store_id1, y.d_week_seq1,
               y.sun_sales1 / x.sun_sales2 AS r1,
               y.mon_sales1 / x.mon_sales2 AS r2,
               y.fri_sales1 / x.fri_sales2 AS r3
        FROM (SELECT s_store_name AS s_store_name1, wss.d_week_seq AS d_week_seq1,
                     s_store_id AS s_store_id1, sun_sales AS sun_sales1,
                     mon_sales AS mon_sales1, fri_sales AS fri_sales1
              FROM wss, store, date_dim d
              WHERE d.d_week_seq = wss.d_week_seq AND ss_store_sk = s_store_sk
                AND d_month_seq BETWEEN 1212 AND 1223) y,
             (SELECT s_store_name AS s_store_name2, wss.d_week_seq AS d_week_seq2,
                     s_store_id AS s_store_id2, sun_sales AS sun_sales2,
                     mon_sales AS mon_sales2, fri_sales AS fri_sales2
              FROM wss, store, date_dim d
              WHERE d.d_week_seq = wss.d_week_seq AND ss_store_sk = s_store_sk
                AND d_month_seq BETWEEN 1224 AND 1235) x
        WHERE y.s_store_id1 = x.s_store_id2
          AND y.d_week_seq1 = x.d_week_seq2 - 52
        ORDER BY y.s_store_name1, y.d_week_seq1, y.s_store_id1 LIMIT 100
    """,
}
