"""Window queries over TPC-H `orders` and `lineitem`, for measuring the port on a card.

Between them they cover every window function kind the port evaluates
(`kernels/relational.WindowSpec`) and every frame (`running`, `range`, `whole`), a
PARTITION BY whose key is NULL for about half of the rows, and one partition spanning
every row.  Each returns one row: an outer aggregate over the window outputs (some
multiplied by a row key, so a value that lands on the wrong row changes the sum), so
that comparing two engines' answers takes no time at SF 1.
"""

WINDOW_QUERIES = {
    # per customer, ORDER BY a date with ties: the RANGE frame (peers share the run end)
    "w_range": """
        SELECT count(*) AS n, sum(rk * (o_orderkey % 1000)) AS rk_k,
               sum(dr * (o_orderkey % 1000)) AS dr_k, sum(run_price) AS run_price,
               sum(run_cnt * (o_orderkey % 1000)) AS cnt_k, sum(run_avg) AS run_avg,
               sum(run_min) AS run_min, sum(run_max) AS run_max,
               sum(lv % 1000) AS lv, sum(fv % 1000) AS fv
        FROM (SELECT o_orderkey,
                     rank() OVER (PARTITION BY o_custkey ORDER BY o_orderdate) AS rk,
                     dense_rank() OVER (PARTITION BY o_custkey ORDER BY o_orderdate) AS dr,
                     sum(o_totalprice) OVER (PARTITION BY o_custkey ORDER BY o_orderdate)
                         AS run_price,
                     count(*) OVER (PARTITION BY o_custkey ORDER BY o_orderdate) AS run_cnt,
                     avg(o_totalprice) OVER (PARTITION BY o_custkey ORDER BY o_orderdate)
                         AS run_avg,
                     min(o_totalprice) OVER (PARTITION BY o_custkey ORDER BY o_orderdate)
                         AS run_min,
                     max(o_totalprice) OVER (PARTITION BY o_custkey ORDER BY o_orderdate)
                         AS run_max,
                     last_value(o_orderkey) OVER (PARTITION BY o_custkey
                                                  ORDER BY o_orderdate) AS lv,
                     first_value(o_orderkey) OVER (PARTITION BY o_custkey
                                                   ORDER BY o_orderdate) AS fv
              FROM orders) t
    """,
    # three status partitions, ROWS .. CURRENT ROW: the running frame, lag and lead
    "w_running": """
        SELECT count(*) AS n, sum(rn * (o_orderkey % 1000)) AS rn_k, sum(s) AS s,
               sum(c * (o_orderkey % 1000)) AS c_k, sum(mn) AS mn, sum(mx) AS mx,
               sum(a) AS a, sum(lv % 1000) AS lv, sum(fv % 1000) AS fv,
               sum(prev_k % 1000) AS prev_k, count(prev_k) AS n_prev,
               sum(next_k % 1000) AS next_k, count(next_k) AS n_next
        FROM (SELECT o_orderkey,
                     row_number() OVER (PARTITION BY o_orderstatus ORDER BY o_orderkey) AS rn,
                     sum(o_totalprice) OVER (PARTITION BY o_orderstatus ORDER BY o_orderkey
                         ROWS BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW) AS s,
                     count(o_totalprice) OVER (PARTITION BY o_orderstatus ORDER BY o_orderkey
                         ROWS BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW) AS c,
                     min(o_totalprice) OVER (PARTITION BY o_orderstatus ORDER BY o_orderkey
                         ROWS BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW) AS mn,
                     max(o_totalprice) OVER (PARTITION BY o_orderstatus ORDER BY o_orderkey
                         ROWS BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW) AS mx,
                     avg(o_totalprice) OVER (PARTITION BY o_orderstatus ORDER BY o_orderkey
                         ROWS BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW) AS a,
                     last_value(o_custkey) OVER (PARTITION BY o_orderstatus ORDER BY o_orderkey
                         ROWS BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW) AS lv,
                     first_value(o_custkey) OVER (PARTITION BY o_orderstatus
                                                  ORDER BY o_orderkey) AS fv,
                     lag(o_orderkey) OVER (PARTITION BY o_orderstatus ORDER BY o_orderkey)
                         AS prev_k,
                     lead(o_orderkey, 2) OVER (PARTITION BY o_orderstatus ORDER BY o_orderkey)
                         AS next_k
              FROM orders) t
    """,
    # NULL partition keys (every 'F' order in one NULL partition), the whole frame
    "w_whole_null_keys": """
        SELECT count(*) AS n, sum(s) AS s, sum(c) AS c, sum(a) AS a, sum(mn) AS mn,
               sum(mx) AS mx, sum(lv % 1000) AS lv, sum(fv % 1000) AS fv,
               count(p) AS non_null_keys
        FROM (SELECT CASE WHEN o_orderstatus = 'F' THEN NULL ELSE o_custkey END AS p,
                     sum(o_totalprice) OVER (PARTITION BY CASE WHEN o_orderstatus = 'F'
                         THEN NULL ELSE o_custkey END) AS s,
                     count(*) OVER (PARTITION BY CASE WHEN o_orderstatus = 'F'
                         THEN NULL ELSE o_custkey END) AS c,
                     avg(o_totalprice) OVER (PARTITION BY CASE WHEN o_orderstatus = 'F'
                         THEN NULL ELSE o_custkey END) AS a,
                     min(o_totalprice) OVER (PARTITION BY CASE WHEN o_orderstatus = 'F'
                         THEN NULL ELSE o_custkey END) AS mn,
                     max(o_totalprice) OVER (PARTITION BY CASE WHEN o_orderstatus = 'F'
                         THEN NULL ELSE o_custkey END) AS mx,
                     last_value(o_orderkey) OVER (PARTITION BY CASE WHEN o_orderstatus = 'F'
                         THEN NULL ELSE o_custkey END ORDER BY o_orderkey
                         ROWS BETWEEN UNBOUNDED PRECEDING AND UNBOUNDED FOLLOWING) AS lv,
                     first_value(o_orderkey) OVER (PARTITION BY CASE WHEN o_orderstatus = 'F'
                         THEN NULL ELSE o_custkey END ORDER BY o_orderkey
                         ROWS BETWEEN UNBOUNDED PRECEDING AND UNBOUNDED FOLLOWING) AS fv
              FROM orders) t
    """,
    # one partition spanning every lineitem row
    "w_one_partition": """
        SELECT count(*) AS n, sum(rn * l_linenumber) AS rn_l, sum(rq) AS rq,
               sum(mx) AS mx, sum(mn) AS mn, sum(rk % 1000) AS rk
        FROM (SELECT l_linenumber,
                     row_number() OVER (ORDER BY l_orderkey, l_linenumber) AS rn,
                     sum(l_quantity) OVER (ORDER BY l_shipdate) AS rq,
                     rank() OVER (ORDER BY l_shipdate) AS rk,
                     max(l_extendedprice) OVER (ORDER BY l_orderkey, l_linenumber
                         ROWS BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW) AS mx,
                     min(l_extendedprice) OVER (ORDER BY l_receiptdate DESC) AS mn
              FROM lineitem) t
    """,
}
