"""Asyncio MySQL-protocol front end (port of `galaxysql_tpu/net/server.py`).

One asyncio task per connection; statements run in a thread pool (`pool_size`
threads) so the event loop keeps serving other connections.  Each connection owns
one `Session` of the instance, whose queries run on the instance's device.

Served commands: handshake and auth (mysql_native_password, by the `users` map or the
metadb's users), the TLS upgrade, the compressed protocol, COM_QUERY
(multi-statement), COM_INIT_DB, COM_PING, COM_FIELD_LIST, COM_STMT_PREPARE / EXECUTE
/ CLOSE / RESET, COM_SET_OPTION, COM_QUIT and COM_BINLOG_DUMP (the change log of
`txn/cdc.py`, paged by seq).

    python -m galaxysql_tpu_torch.net.server [--host H] [--port P] [--init-sql SQL]
                                             [--data-dir DIR] [--announce]
                                             [--sync-port S] [--device cuda|cpu]

serves an instance on the card (`--device cpu` for the CPU), booted from DIR's
metadb and last checkpoint when `--data-dir` is given (a fresh in-memory one
otherwise); `--sync-port` (0 = any free port) opens the coordinator's sync plane
(`CoordinatorSyncListener`), and `--announce` prints `SERVER_READY <port>
<sync_port>` (-1 without a sync plane) once listening.  The server never
checkpoints: a checkpoint is `Instance.save()`, as in the reference.
"""

from __future__ import annotations

import asyncio
import json
import os
import secrets
import struct
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

from galaxysql_tpu_torch.net import packets as P
from galaxysql_tpu_torch.server.instance import Instance
from galaxysql_tpu_torch.server.session import ResultSet, Session
from galaxysql_tpu_torch.sql.parser import parse as parse_sql
from galaxysql_tpu_torch.utils import errors


class PreparedStatement:
    def __init__(self, stmt_id: int, sql: str, n_params: int):
        self.stmt_id = stmt_id
        self.sql = sql
        self.n_params = n_params
        # param types from the first COM_STMT_EXECUTE (connectors omit them later)
        self.param_types = None


class Connection:
    def __init__(self, server: "MySQLServer", reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter):
        self.server = server
        self.reader = reader
        self.writer = writer
        self.session = Session(server.instance)
        self.seq = 0
        self.stmts: Dict[int, PreparedStatement] = {}
        self.next_stmt_id = 1
        self.closed = False
        # compressed protocol (CLIENT_COMPRESS): active after a successful
        # handshake that negotiated it; MySQL packets then ride inside
        # [3B comp-len][1B comp-seq][3B uncompressed-len] frames (zlib when
        # uncompressed-len > 0, verbatim when 0)
        self.compressed = False
        self.cseq = 0
        self._inbuf = b""
        self._outbuf: list = []

    # -- framing ---------------------------------------------------------------

    async def _read_raw(self, n: int) -> bytes:
        """n bytes of the logical (post-decompression) stream."""
        if not self.compressed:
            return await self.reader.readexactly(n)
        import zlib
        while len(self._inbuf) < n:
            hdr = await self.reader.readexactly(7)
            clen = hdr[0] | (hdr[1] << 8) | (hdr[2] << 16)
            self.cseq = (hdr[3] + 1) & 0xFF
            ulen = hdr[4] | (hdr[5] << 8) | (hdr[6] << 16)
            body = await self.reader.readexactly(clen)
            self._inbuf += zlib.decompress(body) if ulen else body
        out, self._inbuf = self._inbuf[:n], self._inbuf[n:]
        return out

    async def read_packet(self) -> Optional[bytes]:
        # reassemble >=16MB payloads split across continuation packets
        payload = b""
        while True:
            header = await self._read_raw(4)
            length = header[0] | (header[1] << 8) | (header[2] << 16)
            self.seq = (header[3] + 1) & 0xFF
            payload += await self._read_raw(length)
            if length < 0xFFFFFF:
                return payload

    def send(self, payload: bytes):
        while True:
            chunk, payload = payload[:0xFFFFFF], payload[0xFFFFFF:]
            header = struct.pack("<I", len(chunk))[:3] + bytes([self.seq])
            self.seq = (self.seq + 1) & 0xFF
            if self.compressed:
                self._outbuf.append(header + chunk)
            else:
                self.writer.write(header + chunk)
            if len(chunk) < 0xFFFFFF:
                break

    MIN_COMPRESS = 50  # MySQL: tiny frames ship uncompressed (ulen = 0)

    async def flush(self):
        if self.compressed and self._outbuf:
            import zlib
            data = b"".join(self._outbuf)
            self._outbuf = []
            for off in range(0, len(data), 0xFFFFF0):
                part = data[off:off + 0xFFFFF0]
                body, ulen = part, 0
                if len(part) >= self.MIN_COMPRESS:
                    z = zlib.compress(part)
                    # incompressible payloads ship verbatim (ulen=0): zlib
                    # expansion could overflow the 3-byte length field
                    if len(z) < len(part):
                        body, ulen = z, len(part)
                hdr = (struct.pack("<I", len(body))[:3] + bytes([self.cseq]) +
                       struct.pack("<I", ulen)[:3])
                self.cseq = (self.cseq + 1) & 0xFF
                self.writer.write(hdr + body)
        await self.writer.drain()

    def _status(self) -> int:
        st = P.SERVER_STATUS_AUTOCOMMIT if self.session.autocommit else 0
        if self.session.txn is not None:
            st |= P.SERVER_STATUS_IN_TRANS
        return st

    # -- lifecycle -------------------------------------------------------------

    async def run(self):
        try:
            await self._run_inner()
        except (asyncio.IncompleteReadError, ConnectionResetError, OSError):
            pass  # client vanished or sent garbage framing: drop quietly
        finally:
            self.session.close()
            try:
                self.writer.close()
            except Exception:  # galaxylint: disable=swallow -- client already vanished; socket close is best-effort
                pass

    async def _upgrade_tls(self):
        """Switch the accepted plaintext stream to TLS in place (SSLRequest).

        `StreamWriter.start_tls` only exists on py>=3.11; on 3.10 this replays
        its implementation over `loop.start_tls`: wrap the raw transport in an
        SSL transport and repoint the writer + stream protocol at it (the
        reader keeps the raw transport — it is only used for flow control,
        exactly what CPython's 3.11 `_replace_writer` does)."""
        ctx = self.server.ssl_context
        if hasattr(self.writer, "start_tls"):
            await self.writer.start_tls(ctx)
            return
        loop = asyncio.get_running_loop()
        protocol = self.writer.transport.get_protocol()
        await self.writer.drain()
        new_tr = await loop.start_tls(self.writer.transport, protocol, ctx,
                                      server_side=True)
        self.writer._transport = new_tr
        protocol._transport = new_tr
        protocol._over_ssl = True

    async def _run_inner(self):
        # salt bytes must avoid NUL: clients read the second half null-terminated
        seed = bytes(secrets.choice(range(1, 256)) for _ in range(20))
        caps = P.SERVER_CAPABILITIES | \
            (P.CLIENT_SSL if self.server.ssl_context is not None else 0)
        self.send(P.handshake_v10(self.session.conn_id, seed, caps))
        await self.flush()
        payload = await self.read_packet()
        # SSLRequest (FrontendCommandHandler.java:99 / net/ssl analog): a short
        # response with CLIENT_SSL set means "switch to TLS now"; the real
        # handshake response then arrives over the encrypted stream
        if len(payload) < 36 and \
                struct.unpack_from("<I", payload, 0)[0] & P.CLIENT_SSL:
            if self.server.ssl_context is None:
                self.send(P.err_packet(3159, "HY000",
                                       "SSL is not enabled on this server"))
                await self.flush()
                return
            await self._upgrade_tls()
            payload = await self.read_packet()
        creds = P.parse_handshake_response(payload)
        if not self.server.authenticate(creds["user"], creds["auth"], seed):
            self.send(P.err_packet(1045, "28000",
                                   f"Access denied for user '{creds['user']}'"))
            await self.flush()
            return
        self.session.user = creds["user"]
        if creds.get("database"):
            try:
                self.session.execute(f"USE `{creds['database']}`")
            except errors.TddlError as e:
                self.send(P.err_packet(e.errno, e.sqlstate, e.message))
                await self.flush()
                return
        self.send(P.ok_packet(status=self._status()))
        await self.flush()
        # the handshake exchange is always uncompressed; the negotiated
        # compressed framing starts with the first command
        self.compressed = bool(creds["capabilities"] & P.CLIENT_COMPRESS)
        while not self.closed:
            self.seq = 0
            self.cseq = 0
            try:
                payload = await self.read_packet()
            except (asyncio.IncompleteReadError, ConnectionResetError):
                break
            if not payload:
                break
            await self.dispatch(payload)
            await self.flush()

    # -- command dispatch --------------------------------------------------------

    async def dispatch(self, payload: bytes):
        cmd = payload[0]
        try:
            if cmd == P.COM_QUIT:
                self.closed = True
            elif cmd == P.COM_PING:
                self.send(P.ok_packet(status=self._status()))
            elif cmd == P.COM_INIT_DB:
                db = payload[1:].decode("utf8", "replace")
                await self.run_blocking(self.session.execute, f"USE `{db}`")
                self.send(P.ok_packet(status=self._status()))
            elif cmd == P.COM_QUERY:
                sql = payload[1:].decode("utf8", "replace")
                results = await self.run_blocking(self.session.execute_all, sql)
                # CLIENT_MULTI_STATEMENTS: every statement's result is sent, with
                # SERVER_MORE_RESULTS_EXISTS on all but the last
                for i, r in enumerate(results):
                    more = P.SERVER_MORE_RESULTS_EXISTS if i + 1 < len(results) else 0
                    self.send_result(r, status_extra=more)
            elif cmd == P.COM_FIELD_LIST:
                table = payload[1:].split(b"\0")[0].decode("utf8", "replace")
                r = await self.run_blocking(self.session.execute,
                                            f"DESC `{table}`")
                for row in r.rows:
                    from galaxysql_tpu_torch.types import datatype as dt
                    self.send(P.column_def(row[0], dt.VARCHAR, table))
                self.send(P.eof_packet(self._status()))
            elif cmd == P.COM_STMT_PREPARE:
                self.stmt_prepare(payload[1:].decode("utf8", "replace"))
            elif cmd == P.COM_STMT_EXECUTE:
                await self.stmt_execute(payload)
            elif cmd == P.COM_STMT_SEND_LONG_DATA:
                pass  # protocol: NO response; long-data binding not yet supported
            elif cmd == P.COM_STMT_CLOSE:
                stmt_id = struct.unpack_from("<I", payload, 1)[0]
                self.stmts.pop(stmt_id, None)  # no response
            elif cmd == P.COM_STMT_RESET:
                self.send(P.ok_packet(status=self._status()))
            elif cmd == P.COM_SET_OPTION:
                self.send(P.eof_packet(self._status()))
            elif cmd == P.COM_BINLOG_DUMP:
                await self.binlog_dump(payload)
            else:
                self.send(P.err_packet(1047, "08S01", f"Unknown command {cmd:#x}"))
        except errors.TddlError as e:
            self.send(P.err_packet(e.errno, e.sqlstate, e.message))
        except Exception as e:  # pragma: no cover - hardening
            self.send(P.err_packet(1105, "HY000", f"{type(e).__name__}: {e}"))

    BINLOG_DUMP_NON_BLOCK = 0x01

    async def binlog_dump(self, payload: bytes):
        """COM_BINLOG_DUMP: stream the change log (`txn/cdc.py`) from a position.

        Each packet is [0x00][json event] with seq, commit_ts, schema, table, kind
        and payload, the wire form `net/client.py` reads and `cdc.replay` applies.
        The position is the last event SEQ seen (0 = from the start): by seq, so a
        transaction whose events straddle a page resumes without loss.  With
        BINLOG_DUMP_NON_BLOCK the stream ends in EOF at the log's end; otherwise it
        keeps tailing until the client drops."""
        pos = struct.unpack_from("<I", payload, 1)[0]
        flags = struct.unpack_from("<H", payload, 5)[0] \
            if len(payload) >= 7 else self.BINLOG_DUMP_NON_BLOCK
        since = int(pos)
        if len(payload) >= 19:
            # seq positions may exceed the 4-byte pos field: clients append the
            # full 64-bit watermark where the file name would sit
            since = struct.unpack_from("<Q", payload, 11)[0]
        cdc = self.session.instance.cdc
        page = 10000
        while not self.closed:
            events = await self.run_blocking(cdc.events_after_seq, since, page)
            for seq, cts, schema, table, kind, pl in events:
                ev = {"seq": seq, "commit_ts": cts, "schema": schema,
                      "table": table, "kind": kind, "payload": pl}
                self.send(b"\x00" + json.dumps(ev).encode("utf8"))
                since = max(since, seq)
            await self.flush()
            if len(events) == page:
                continue  # more pages pending: drain before EOF or tailing
            if flags & self.BINLOG_DUMP_NON_BLOCK:
                self.send(P.eof_packet(self._status()))
                return
            await asyncio.sleep(0.2)  # tail the log

    async def run_blocking(self, fn, *args):
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(self.server.pool, fn, *args)

    def send_result(self, r: ResultSet, binary: bool = False,
                    status_extra: int = 0):
        status = self._status() | status_extra
        if not r.is_query:
            self.send(P.ok_packet(r.affected, r.last_insert_id, status,
                                  info=r.info.encode("utf8")))
            return
        self.send(P.lenenc_int(len(r.names)))
        for name, typ in zip(r.names, r.types):
            self.send(P.column_def(name, typ))
        self.send(P.eof_packet(status))
        for row in r.rows:
            if binary:
                self.send(P.binary_row(row, r.types))
            else:
                self.send(P.text_row(row))
        self.send(P.eof_packet(status))

    # -- prepared statements -------------------------------------------------------

    def stmt_prepare(self, sql: str):
        from galaxysql_tpu_torch.sql.lexer import T, tokenize
        parse_sql(sql)  # validate syntax up front (errors -> ERR packet)
        n_params = sum(1 for t in tokenize(sql) if t.kind == T.PARAM)
        stmt = PreparedStatement(self.next_stmt_id, sql, n_params)
        self.next_stmt_id += 1
        self.stmts[stmt.stmt_id] = stmt
        # response: [ok][stmt_id][n_cols][n_params][filler][warnings]
        head = (b"\x00" + struct.pack("<I", stmt.stmt_id) +
                struct.pack("<H", 0) + struct.pack("<H", n_params) +
                b"\x00" + struct.pack("<H", 0))
        self.send(head)
        if n_params:
            from galaxysql_tpu_torch.types import datatype as dt
            for i in range(n_params):
                self.send(P.column_def(f"?{i}", dt.VARCHAR))
            self.send(P.eof_packet(self._status()))

    async def stmt_execute(self, payload: bytes):
        stmt_id = struct.unpack_from("<I", payload, 1)[0]
        stmt = self.stmts.get(stmt_id)
        if stmt is None:
            self.send(P.err_packet(1243, "HY000", "Unknown prepared statement"))
            return
        params, types = P.parse_stmt_execute_params(payload, stmt.n_params,
                                                     stmt.param_types)
        if types:
            stmt.param_types = types
        r = await self.run_blocking(self.session.execute, stmt.sql, params)
        self.send_result(r, binary=True)


class MySQLServer:
    """The frontend acceptor (CobarServer.startupServer analog, §3.1)."""

    def __init__(self, instance: Instance, host: str = "127.0.0.1", port: int = 3406,
                 users: Optional[Dict[str, str]] = None, pool_size: int = 16,
                 ssl_certfile: Optional[str] = None,
                 ssl_keyfile: Optional[str] = None):
        self.instance = instance
        self.host = host
        self.port = port
        self.users = users  # None -> authenticate against the metadb user table
        self.pool = ThreadPoolExecutor(max_workers=pool_size,
                                       thread_name_prefix="exec")
        self._server: Optional[asyncio.AbstractServer] = None
        # TLS (net/ssl analog): when a cert is configured the handshake
        # advertises CLIENT_SSL and honors the SSLRequest upgrade
        self.ssl_context = None
        if ssl_certfile:
            import ssl as _ssl
            ctx = _ssl.SSLContext(_ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(ssl_certfile, ssl_keyfile)
            self.ssl_context = ctx

    def authenticate(self, user: str, auth: bytes, seed: bytes) -> bool:
        # explicit user map (tests) takes precedence; otherwise the metadb
        # privilege tables decide (PolarPrivManager analog)
        if self.users is not None and user in self.users:
            password = self.users[user].encode("utf8")
            if not password:
                return auth in (b"", b"\0")
            return auth == P.native_password_scramble(password, seed)
        if self.users is not None:
            return False
        import hashlib
        stored = self.instance.privileges.password_hash(user)  # SHA1(SHA1(pw))
        if stored is None:
            return False
        if not stored:
            return auth in (b"", b"\0")
        if not auth:
            return False
        # scramble = SHA1(pw) XOR SHA1(seed + stored); recover SHA1(pw) and verify
        h3 = hashlib.sha1(seed + stored).digest()
        sha1_pw = bytes(a ^ b for a, b in zip(auth, h3))
        return hashlib.sha1(sha1_pw).digest() == stored

    async def start(self):
        async def handler(reader, writer):
            conn = Connection(self, reader, writer)
            await conn.run()

        self._server = await asyncio.start_server(handler, self.host, self.port)
        if self.port == 0:
            self.port = self._server.sockets[0].getsockname()[1]

    async def stop(self):
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        self.pool.shutdown(wait=False)

    async def serve_forever(self):
        await self.start()
        await self._server.serve_forever()


class CoordinatorSyncListener:
    """The dn-wire sync endpoint of a coordinator process: a peer dials it with the
    same `WorkerClient` it uses for workers, so `ping` and `sync` ops (and the RPC
    failpoints, the circuit breaker, retry budgets) work against a peer
    coordinator unchanged.  `sync` dispatches into `Instance.apply_sync_action`.
    Replies carry the reference's `wl` load piggyback: the admitted in-flight
    count, the memory tier, the uptime and the metric-history sample count."""

    def __init__(self, instance: Instance):
        self.instance = instance
        self.port = 0
        self._srv = None
        self._thread = None

    def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        import socket
        import threading
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, port))
        srv.listen(16)
        self.port = srv.getsockname()[1]
        self._srv = srv
        self._thread = threading.Thread(target=self._accept_loop, args=(srv,),
                                        daemon=True)
        self._thread.start()
        return self.port

    def stop(self):
        if self._srv is not None:
            try:
                self._srv.close()
            except OSError:
                pass
            self._srv = None

    def _accept_loop(self, srv):
        import threading
        while True:
            try:
                conn, _ = srv.accept()
            except OSError:
                return  # listener closed
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _handle(self, header: dict) -> dict:
        inst = self.instance
        op = header.get("op")
        if op == "ping":
            resp = {"ok": True, "node": inst.node_id}
        elif op == "sync":
            try:
                resp = inst.apply_sync_action(header.get("action"),
                                              header.get("payload") or {})
            except Exception as e:
                resp = {"error": f"{type(e).__name__}: {e}",
                        "errno": int(getattr(e, "errno", 1105) or 1105)}
        else:
            resp = {"error": f"unknown op {op!r} (coordinator sync plane "
                             f"serves ping/sync only)"}
        if isinstance(resp, dict) and "wl" not in resp:
            try:
                adm = inst.admission
                snap = adm.cluster_snapshot()
                q = int(snap["tp"]["inflight"] + snap["ap"]["inflight"])
                resp["wl"] = {"q": q, "mt": adm.governor.tier(),
                              "up": round(time.time() - inst.started_at, 1),
                              "ns": inst.metric_history.samples_count}
            except Exception:  # galaxylint: disable=swallow -- load telemetry must never fail a gossip reply; workers do the same
                pass
        return resp

    def _serve_conn(self, conn):
        import socket
        from galaxysql_tpu_torch.net.dn import recv_msg, send_msg
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            while True:
                header, _arrays = recv_msg(conn)
                send_msg(conn, self._handle(header), {})
        except (ConnectionError, OSError, errors.ProtocolError):
            pass  # the peer hung up, or a corrupt frame: drop the connection
        finally:
            conn.close()


def main(argv=None):  # pragma: no cover - manual entry point
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=3406)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--init-sql", default=None,
                    help="semicolon-separated bootstrap statements")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the torch device every query runs on (default: cuda)")
    ap.add_argument("--data-dir", default=None,
                    help="the metadb and checkpoint directory to boot from "
                         "(default: an in-memory metadb)")
    ap.add_argument("--sync-port", type=int, default=-1,
                    help="coordinator sync-plane port (0 = auto, -1 = off)")
    ap.add_argument("--announce", action="store_true",
                    help="print 'SERVER_READY <mysql_port> <sync_port>' once "
                         "listening")
    args = ap.parse_args(argv)
    inst = Instance(data_dir=args.data_dir, device=args.device)
    if args.init_sql:
        sess = Session(inst)
        sess.execute_all(args.init_sql)
        sess.close()
    sync = None
    if args.sync_port >= 0:
        sync = CoordinatorSyncListener(inst)
        sync.start(args.host, args.sync_port)
    server = MySQLServer(inst, args.host, args.port)

    async def _serve():
        await server.start()
        if args.announce:
            print(f"SERVER_READY {server.port} {sync.port if sync else -1}",
                  flush=True)
        await server._server.serve_forever()

    asyncio.run(_serve())


if __name__ == "__main__":  # pragma: no cover
    main()
