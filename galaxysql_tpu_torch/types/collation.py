"""Collation handlers: COLLATE semantics over dictionary-encoded strings.

Reference analog: `polardbx-common/.../charset` + `common/collation/*` (~30
handlers).  On this engine a collation is a host-side *fold function*: two
strings compare equal iff their folds are equal.  Because string lanes are
dictionary codes, a collation materializes as a code->representative-code
translation table built once per (dictionary version, collation) — on device
a comparison under any collation is still one gather + integer compare.

Handlers: binary / *_bin (identity), *_general_ci and *_ci (case fold),
*_unicode_ci / *_0900_ai_ci (accent-insensitive case fold via NFD strip).
Unknown collations raise — silently falling back to binary would change query
results.
"""

from __future__ import annotations

import unicodedata
from typing import Callable, Dict, Tuple

import numpy as np


def _ident(s: str) -> str:
    return s


def _ci(s: str) -> str:
    return s.casefold()


def _ai_ci(s: str) -> str:
    decomposed = unicodedata.normalize("NFD", s)
    return "".join(c for c in decomposed
                   if not unicodedata.combining(c)).casefold()


# The MySQL collation name surface mapped onto handler families
# (`polardbx-common/.../common/collation/*CollationHandler`;
# `docs/design/PolarDB-X Charset & Collation.md` lists the supported set).
# family: bin = identity, ci = case fold, ai_ci = accent-insensitive case fold,
# cs = case-sensitive accent-sensitive (identity fold, collation-ordered).
COLLATIONS: Dict[str, str] = {
    "binary": "bin",
    "utf8mb4_bin": "bin", "utf8_bin": "bin", "utf8mb3_bin": "bin",
    "latin1_bin": "bin", "ascii_bin": "bin", "gbk_bin": "bin",
    "utf16_bin": "bin", "utf32_bin": "bin", "ucs2_bin": "bin",
    "big5_bin": "bin", "gb18030_bin": "bin",
    "utf8mb4_general_ci": "ci", "utf8_general_ci": "ci",
    "utf8mb3_general_ci": "ci", "latin1_general_ci": "ci",
    "latin1_swedish_ci": "ci", "latin1_danish_ci": "ci",
    "ascii_general_ci": "ci", "gbk_chinese_ci": "ci",
    "utf16_general_ci": "ci", "utf32_general_ci": "ci",
    "ucs2_general_ci": "ci", "big5_chinese_ci": "ci",
    "gb18030_chinese_ci": "ci",
    "utf8mb4_unicode_ci": "ai_ci", "utf8_unicode_ci": "ai_ci",
    "utf8mb3_unicode_ci": "ai_ci", "utf8mb4_unicode_520_ci": "ai_ci",
    "utf8mb4_0900_ai_ci": "ai_ci", "utf16_unicode_ci": "ai_ci",
    "utf32_unicode_ci": "ai_ci", "ucs2_unicode_ci": "ai_ci",
    "utf8mb4_0900_as_cs": "cs", "utf8mb4_general_cs": "cs",
    "latin1_general_cs": "cs",
}

_FAMILY_FOLDS: Dict[str, Callable[[str], str]] = {
    "bin": _ident, "ci": _ci, "ai_ci": _ai_ci, "cs": _ident,
}


def family_of(name: str) -> str:
    n = name.lower()
    fam = COLLATIONS.get(n)
    if fam is not None:
        return fam
    # names outside the enumerated set still resolve by suffix convention
    if n.endswith("_bin"):
        return "bin"
    if n.endswith(("_unicode_ci", "_0900_ai_ci", "_unicode_520_ci")):
        return "ai_ci"
    if n.endswith("_ci"):
        return "ci"
    if n.endswith(("_cs", "_as_cs")):
        return "cs"
    from galaxysql_tpu_torch.utils import errors
    raise errors.NotSupportedError(f"unknown collation '{name}'")


def fold_fn(name: str) -> Callable[[str], str]:
    return _FAMILY_FOLDS[family_of(name)]


# (dictionary uid, len, collation) -> (table, fold->rep_code map)
_REP_CACHE: Dict[Tuple, Tuple[np.ndarray, dict]] = {}


def _rep(dictionary, name: str) -> Tuple[np.ndarray, dict]:
    key = (dictionary.uid, len(dictionary), name.lower())
    hit = _REP_CACHE.get(key)
    if hit is not None:
        return hit
    fold = fold_fn(name)
    by_fold: dict = {}
    table = np.empty(max(len(dictionary), 1), dtype=np.int32)
    for code, v in enumerate(dictionary.values):
        table[code] = by_fold.setdefault(fold(v), code)
    if len(_REP_CACHE) > 512:
        _REP_CACHE.clear()
    _REP_CACHE[key] = (table, by_fold)
    return table, by_fold


def rep_table(dictionary, name: str) -> np.ndarray:
    """code -> fold-class representative code (equality under the collation
    becomes integer equality of translated codes)."""
    return _rep(dictionary, name)[0]


# (dictionary uid, len, collation) -> (rank table, rank -> representative code)
_RANK_CACHE: Dict[Tuple, Tuple[np.ndarray, np.ndarray]] = {}


def rank_under(dictionary, name: str) -> Tuple[np.ndarray, np.ndarray, list]:
    """Collation SORT KEYS: (rank, order, distinct_folds) where rank[code] is the dense rank
    of fold(value) among the distinct folds in sorted order, and
    order[rank] is a representative code of that fold class.

    Collation-equal strings get EQUAL ranks (MySQL: 'a' = 'A' under *_ci, so
    ORDER BY leaves their relative order unspecified), and class order is by
    the folded text — 'a' < 'B' under *_ci where binary code order says
    otherwise (the UCA-weight approximation of the reference's
    *CollationHandler sort keys)."""
    key = (dictionary.uid, len(dictionary), name.lower())
    hit = _RANK_CACHE.get(key)
    if hit is not None:
        return hit
    fold = fold_fn(name)
    folds = [fold(v) for v in dictionary.values]
    distinct = sorted(set(folds))
    pos = {f: r for r, f in enumerate(distinct)}
    n = max(len(dictionary), 1)
    rank = np.zeros(n, dtype=np.int32)
    order = np.zeros(n, dtype=np.int32)
    for code, f in enumerate(folds):
        r = pos[f]
        rank[code] = r
    for code in range(len(folds) - 1, -1, -1):  # first member represents
        order[rank[code]] = code
    if len(_RANK_CACHE) > 512:
        _RANK_CACHE.clear()
    _RANK_CACHE[key] = (rank, order, distinct)
    return _RANK_CACHE[key]


def class_bound(dictionary, name: str, s: str, side: str) -> int:
    """Rank-space boundary of literal `s` under the collation: bisect over the
    sorted distinct folds ('left' or 'right'), for half-open range compares.
    Reuses rank_under's cached distinct-fold list (same cache entry)."""
    import bisect
    rank_under(dictionary, name)  # populate/refresh the cache entry
    distinct = _RANK_CACHE[(dictionary.uid, len(dictionary), name.lower())][2]
    target = fold_fn(name)(s)
    return (bisect.bisect_left(distinct, target) if side == "left"
            else bisect.bisect_right(distinct, target))


def collation_of_expr(e) -> "str | None":
    """The collation name an expression carries (binder tags dict_transform
    nodes with ('collate', name) meta), or None."""
    meta = getattr(e, "meta", None)
    if meta is not None and len(meta) >= 3 and meta[1] == "collate":
        return meta[2]
    return None


def sort_rank_array(e, dictionary) -> np.ndarray:
    """The rank table ORDER BY/min/max should run on for string expr `e`:
    collation-ordered when the expr carries a COLLATE, binary otherwise."""
    name = collation_of_expr(e)
    if name is not None:
        return rank_under(dictionary, name)[0]
    return dictionary.rank_array()


def sort_order_array(e, dictionary) -> np.ndarray:
    """rank -> code decode table matching sort_rank_array (min/max winners)."""
    name = collation_of_expr(e)
    if name is not None:
        return rank_under(dictionary, name)[1]
    return dictionary.sorted_order()


def rep_text(dictionary, name: str, s: str) -> str:
    """The representative ORIGINAL text of s's fold class in this dictionary
    (encoding it yields the representative code); s itself when no dictionary
    member folds equal (the comparison then correctly matches nothing)."""
    table, by_fold = _rep(dictionary, name)
    code = by_fold.get(fold_fn(name)(s))
    return dictionary.values[code] if code is not None else s
