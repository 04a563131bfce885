"""Privilege system: users, grants, authorization checks.

Reference analog: `gms/privilege/PolarPrivManager` (SURVEY.md §2.8) — users and
schema/table-scoped privileges persisted in the metadb, checked on every statement.
Passwords are stored as SHA1(SHA1(password)) (the mysql_native_password server-side
form), so wire auth can verify scrambles without plaintext.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Dict, List, Optional, Set, Tuple

from galaxysql_tpu_torch.utils import errors

_PRIV_SCHEMA = """
CREATE TABLE IF NOT EXISTS user_priv (
    user TEXT PRIMARY KEY, password_hash BLOB, is_super INTEGER);
CREATE TABLE IF NOT EXISTS db_priv (
    user TEXT, schema_name TEXT, table_name TEXT, priv TEXT,
    PRIMARY KEY (user, schema_name, table_name, priv));
"""

ALL_PRIVS = {"SELECT", "INSERT", "UPDATE", "DELETE", "CREATE", "DROP", "ALTER",
             "INDEX"}


def double_sha1(password: str) -> bytes:
    if not password:
        return b""
    return hashlib.sha1(hashlib.sha1(password.encode()).digest()).digest()


class PrivilegeManager:
    def __init__(self, metadb):
        self.metadb = metadb
        with metadb._lock:
            metadb._conn.executescript(_PRIV_SCHEMA)
            metadb._conn.commit()
        # decision caches: EVERY query authorizes, and a metadb (sqlite) hit
        # on that path releases+reacquires the GIL — at high session counts
        # the reacquisition convoy alone caps the whole server near
        # 1/switch-interval QPS.  Invalidated wholesale on any user/grant
        # mutation (replace-not-mutate keeps lock-free readers consistent).
        self._decisions: dict = {}
        self._supers: dict = {}
        # generation guard for the check-then-cache race: the sqlite read
        # releases the GIL, so a mutation + _invalidate can land between a
        # reader's query and its cache insert — the reader must not store a
        # pre-mutation decision into the post-mutation dict
        self._gen = 0
        if not self.metadb.query("SELECT 1 FROM user_priv WHERE user='root'"):
            self.create_user("root", "", super_user=True, if_not_exists=True)

    def _invalidate(self):
        self._gen += 1
        self._decisions = {}
        self._supers = {}

    def invalidate_cache(self):
        """Drop the decision caches — the sync-bus receiver for privilege
        mutations made on a PEER coordinator sharing this metadb (local
        mutations invalidate inline; peers only share the sqlite file)."""
        self._invalidate()

    # -- user management ---------------------------------------------------------

    def create_user(self, user: str, password: str, super_user: bool = False,
                    if_not_exists: bool = False):
        exists = bool(self.metadb.query("SELECT 1 FROM user_priv WHERE user=?",
                                        (user,)))
        if exists:
            if if_not_exists:
                return
            raise errors.TddlError(f"User '{user}' already exists")
        self.metadb.execute("INSERT INTO user_priv VALUES (?,?,?)",
                            (user, double_sha1(password), int(super_user)))
        self._invalidate()

    def drop_user(self, user: str, if_exists: bool = False):
        if user == "root":
            raise errors.TddlError("cannot drop 'root'")
        n = self.metadb.execute("DELETE FROM user_priv WHERE user=?", (user,)).rowcount
        if not n and not if_exists:
            raise errors.TddlError(f"User '{user}' does not exist")
        self.metadb.execute("DELETE FROM db_priv WHERE user=?", (user,))
        self._invalidate()

    def password_hash(self, user: str) -> Optional[bytes]:
        rows = self.metadb.query(
            "SELECT password_hash FROM user_priv WHERE user=?", (user,))
        return bytes(rows[0][0]) if rows else None

    def user_exists(self, user: str) -> bool:
        return self.password_hash(user) is not None

    def is_super(self, user: str) -> bool:
        hit = self._supers.get(user)
        if hit is None:
            gen = self._gen
            rows = self.metadb.query(
                "SELECT is_super FROM user_priv WHERE user=?", (user,))
            hit = bool(rows and rows[0][0])
            if gen == self._gen and len(self._supers) < 4096:
                self._supers[user] = hit
        return hit

    # -- grants ------------------------------------------------------------------

    def grant(self, user: str, privs: List[str], schema: str, table: str):
        if not self.user_exists(user):
            raise errors.TddlError(f"User '{user}' does not exist")
        expanded = ALL_PRIVS if privs == ["ALL"] else set(p.upper() for p in privs)
        for p in expanded:
            self.metadb.execute(
                "INSERT OR IGNORE INTO db_priv VALUES (?,?,?,?)",
                (user, schema.lower(), table.lower(), p))
        self._invalidate()

    def revoke(self, user: str, privs: List[str], schema: str, table: str):
        expanded = ALL_PRIVS if privs == ["ALL"] else set(p.upper() for p in privs)
        for p in expanded:
            self.metadb.execute(
                "DELETE FROM db_priv WHERE user=? AND schema_name=? AND "
                "table_name=? AND priv=?", (user, schema.lower(), table.lower(), p))
        self._invalidate()

    def has_privilege(self, user: str, priv: str, schema: str,
                      table: str = "*") -> bool:
        key = (user, priv, schema.lower(), table.lower())
        hit = self._decisions.get(key)
        if hit is not None:
            return hit
        gen = self._gen
        if self.is_super(user):
            got = True
        elif key[2] == "information_schema" and priv == "SELECT":
            got = True
        else:
            got = bool(self.metadb.query(
                "SELECT 1 FROM db_priv WHERE user=? AND priv=? AND "
                "(schema_name='*' OR schema_name=?) AND "
                "(table_name='*' OR table_name=?) LIMIT 1",
                (user, priv.upper(), key[2], key[3])))
        if gen == self._gen and len(self._decisions) < 4096:
            self._decisions[key] = got
        return got

    def check(self, user: str, priv: str, schema: str, table: str = "*"):
        if not self.has_privilege(user, priv, schema, table):
            raise errors.AccessDeniedError(
                f"{priv} command denied to user '{user}' for "
                f"'{schema}.{table if table != '*' else '*'}'")

    def grants_for(self, user: str) -> List[Tuple[str, str, str]]:
        return self.metadb.query(
            "SELECT priv, schema_name, table_name FROM db_priv WHERE user=? "
            "ORDER BY schema_name, table_name, priv", (user,))
