"""Minimal blocking MySQL client (tests + tooling).

Speaks the same wire dialect the server emits: handshake v10 + mysql_native_password,
COM_QUERY with text resultsets, COM_STMT_PREPARE/EXECUTE with binary rows.  Kept
deliberately simple — it exists so protocol tests exercise real bytes end-to-end
without an external driver.
"""

from __future__ import annotations

import socket
import struct
from typing import Any, List, Optional, Tuple

from galaxysql_tpu_torch.net import packets as P


class MySQLError(Exception):
    def __init__(self, errno: int, sqlstate: str, message: str):
        super().__init__(f"({errno}, {sqlstate}): {message}")
        self.errno = errno
        self.sqlstate = sqlstate
        self.message = message


class MiniClient:
    def __init__(self, host: str, port: int, user: str = "root", password: str = "",
                 database: Optional[str] = None, timeout: float = 30.0,
                 compress: bool = False, use_ssl: bool = False):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.seq = 0
        self.more_results = False
        # compressed protocol: negotiated at handshake, framing active after
        self.compress = compress
        self.compressed = False
        self.use_ssl = use_ssl
        self.cseq = 0
        self._inbuf = b""
        self._handshake(user, password, database)
        if compress:
            self.compressed = True

    # -- framing ---------------------------------------------------------------

    def _read_raw(self, n: int) -> bytes:
        if not self.compressed:
            return self._recvn(n)
        import zlib
        while len(self._inbuf) < n:
            hdr = self._recvn(7)
            clen = hdr[0] | (hdr[1] << 8) | (hdr[2] << 16)
            self.cseq = (hdr[3] + 1) & 0xFF
            ulen = hdr[4] | (hdr[5] << 8) | (hdr[6] << 16)
            body = self._recvn(clen)
            self._inbuf += zlib.decompress(body) if ulen else body
        out, self._inbuf = self._inbuf[:n], self._inbuf[n:]
        return out

    def _read_packet(self) -> bytes:
        payload = b""
        while True:
            header = self._read_raw(4)
            length = header[0] | (header[1] << 8) | (header[2] << 16)
            self.seq = (header[3] + 1) & 0xFF
            payload += self._read_raw(length)
            if length < 0xFFFFFF:
                return payload

    def _recvn(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("server closed connection")
            buf += chunk
        return buf

    def _send(self, payload: bytes):
        frames = []
        while True:
            chunk, payload = payload[:0xFFFFFF], payload[0xFFFFFF:]
            header = struct.pack("<I", len(chunk))[:3] + bytes([self.seq])
            self.seq = (self.seq + 1) & 0xFF
            frames.append(header + chunk)
            if len(chunk) < 0xFFFFFF:
                break
        data = b"".join(frames)
        if not self.compressed:
            self.sock.sendall(data)
            return
        import zlib
        # chunk at the same bound the server uses: one compressed frame may not
        # describe more than 2^24-1 payload bytes (3-byte lengths on the wire)
        out = []
        while data:
            chunk, data = data[:0xFFFFF0], data[0xFFFFF0:]
            body, ulen = chunk, 0
            if len(chunk) >= 50:
                z = zlib.compress(chunk)
                # MySQL rule: ship uncompressed (ulen=0) when zlib does not
                # shrink — worst-case expansion on incompressible input would
                # overflow the 3-byte compressed-length field
                if len(z) < len(chunk):
                    body, ulen = z, len(chunk)
            hdr = (struct.pack("<I", len(body))[:3] + bytes([self.cseq]) +
                   struct.pack("<I", ulen)[:3])
            self.cseq = (self.cseq + 1) & 0xFF
            out.append(hdr + body)
        self.sock.sendall(b"".join(out))

    def _command(self, payload: bytes):
        self.seq = 0
        self.cseq = 0
        self._send(payload)

    # -- handshake -------------------------------------------------------------

    def _handshake(self, user: str, password: str, database: Optional[str]):
        greeting = self._read_packet()
        if greeting[0] == 0xFF:
            raise self._err(greeting)
        pos = 1
        end = greeting.index(b"\0", pos)
        self.server_version = greeting[pos:end].decode()
        pos = end + 1
        self.conn_id = struct.unpack_from("<I", greeting, pos)[0]
        pos += 4
        seed = greeting[pos:pos + 8]
        pos += 9
        pos += 2 + 1 + 2 + 2 + 1 + 10  # caps_lo, charset, status, caps_hi, authlen, pad
        end = greeting.index(b"\0", pos)
        seed += greeting[pos:end]
        caps = (P.CLIENT_PROTOCOL_41 | P.CLIENT_SECURE_CONNECTION |
                P.CLIENT_PLUGIN_AUTH | P.CLIENT_MULTI_STATEMENTS |
                P.CLIENT_TRANSACTIONS)
        if self.compress:
            caps |= P.CLIENT_COMPRESS
        if database:
            caps |= P.CLIENT_CONNECT_WITH_DB
        if self.use_ssl:
            # SSLRequest: short header-only response with CLIENT_SSL, then the
            # TLS handshake; the credentialed response goes over the ciphertext
            import ssl as _ssl
            sslreq = struct.pack("<IIB", caps | P.CLIENT_SSL, 1 << 24, 255) + \
                b"\0" * 23
            self._send(sslreq)
            ctx = _ssl.SSLContext(_ssl.PROTOCOL_TLS_CLIENT)
            ctx.check_hostname = False
            ctx.verify_mode = _ssl.CERT_NONE  # self-signed server cert (tests)
            self.sock = ctx.wrap_socket(self.sock)
            caps |= P.CLIENT_SSL
        auth = P.native_password_scramble(password.encode(), seed[:20])
        payload = struct.pack("<IIB", caps, 1 << 24, 255) + b"\0" * 23
        payload += user.encode() + b"\0"
        payload += bytes([len(auth)]) + auth
        if database:
            payload += database.encode() + b"\0"
        payload += b"mysql_native_password\0"
        self._send(payload)
        resp = self._read_packet()
        if resp[0] == 0xFF:
            raise self._err(resp)

    def _err(self, payload: bytes) -> MySQLError:
        errno = struct.unpack_from("<H", payload, 1)[0]
        sqlstate = payload[4:9].decode("ascii", "replace")
        message = payload[9:].decode("utf8", "replace")
        return MySQLError(errno, sqlstate, message)

    # -- queries -----------------------------------------------------------------

    def query(self, sql: str) -> Tuple[List[str], List[Tuple]]:
        """Returns the LAST statement's (column names, rows); use query_all for all."""
        return self.query_all(sql)[-1]

    def query_all(self, sql: str) -> List[Tuple[List[str], List[Tuple]]]:
        self._command(bytes([P.COM_QUERY]) + sql.encode("utf8"))
        out = [self._read_result(binary=False)]
        while self.more_results:
            out.append(self._read_result(binary=False))
        return out

    def ping(self) -> bool:
        self._command(bytes([P.COM_PING]))
        return self._read_packet()[0] == 0

    def binlog_dump(self, since_seq: int = 0, non_block: bool = True) -> list:
        """COM_BINLOG_DUMP: pull the CDC change stream from a SEQ position.

        Returns the decoded event dicts (non-blocking mode reads to the log's
        end).  Each event carries seq/commit_ts/schema/table/kind/payload —
        the server's logical binlog wire form (txn/cdc.py); resume from the
        max seq seen."""
        import json
        flags = 0x01 if non_block else 0
        payload = (bytes([P.COM_BINLOG_DUMP]) +
                   struct.pack("<I", since_seq & 0xFFFFFFFF) +
                   struct.pack("<H", flags) +
                   struct.pack("<I", 1) + struct.pack("<Q", since_seq))
        self._command(payload)
        events = []
        while True:
            pkt = self._read_packet()
            if pkt[0] == 0xFF:
                raise self._err(pkt)
            if pkt[0] == 0xFE and len(pkt) < 9:
                return events  # EOF
            events.append(json.loads(pkt[1:].decode("utf8")))

    def prepare(self, sql: str) -> int:
        self._command(bytes([P.COM_STMT_PREPARE]) + sql.encode("utf8"))
        resp = self._read_packet()
        if resp[0] == 0xFF:
            raise self._err(resp)
        stmt_id = struct.unpack_from("<I", resp, 1)[0]
        n_params = struct.unpack_from("<H", resp, 7)[0]
        for _ in range(n_params):
            self._read_packet()
        if n_params:
            self._read_packet()  # EOF
        self._stmt_params = getattr(self, "_stmt_params", {})
        self._stmt_params[stmt_id] = n_params
        return stmt_id

    def execute(self, stmt_id: int, params: List[Any]) -> Tuple[List[str], List[Tuple]]:
        n = self._stmt_params.get(stmt_id, len(params))
        payload = bytearray(bytes([P.COM_STMT_EXECUTE]) +
                            struct.pack("<IBI", stmt_id, 0, 1))
        if n:
            null_bitmap = bytearray((n + 7) // 8)
            types = bytearray()
            values = bytearray()
            for i, v in enumerate(params):
                if v is None:
                    null_bitmap[i // 8] |= 1 << (i % 8)
                    types += bytes([P.T_NULL, 0])
                elif isinstance(v, bool):
                    types += bytes([P.T_TINY, 0])
                    values += struct.pack("<b", int(v))
                elif isinstance(v, int):
                    types += bytes([P.T_LONGLONG, 0])
                    values += struct.pack("<q", v)
                elif isinstance(v, float):
                    types += bytes([P.T_DOUBLE, 0])
                    values += struct.pack("<d", v)
                else:
                    types += bytes([P.T_VAR_STRING, 0])
                    values += P.lenenc_str(str(v).encode("utf8"))
            payload += bytes(null_bitmap) + b"\x01" + bytes(types) + bytes(values)
        self._command(bytes(payload))
        return self._read_result(binary=True)

    def _read_result(self, binary: bool) -> Tuple[List[str], List[Tuple]]:
        first = self._read_packet()
        if first[0] == 0xFF:
            self.more_results = False
            raise self._err(first)
        if first[0] == 0x00:
            # OK packet: [affected][last_id][status][warnings]
            pos = 1
            _, pos = P.read_lenenc_int(first, pos)
            _, pos = P.read_lenenc_int(first, pos)
            status = struct.unpack_from("<H", first, pos)[0]
            self.more_results = bool(status & P.SERVER_MORE_RESULTS_EXISTS)
            return [], []
        n_cols, _ = P.read_lenenc_int(first, 0)
        names: List[str] = []
        types: List[int] = []
        for _ in range(n_cols):
            cd = self._read_packet()
            pos = 0
            for _field in range(4):  # catalog, schema, table, org_table
                _, pos = P.read_lenenc_str(cd, pos)
            name, pos = P.read_lenenc_str(cd, pos)
            _, pos = P.read_lenenc_str(cd, pos)
            pos += 1 + 2 + 4
            types.append(cd[pos])
            names.append(name.decode("utf8"))
        self._read_packet()  # EOF
        rows: List[Tuple] = []
        while True:
            pkt = self._read_packet()
            if pkt[0] == 0xFE and len(pkt) < 9:
                status = struct.unpack_from("<H", pkt, 3)[0]
                self.more_results = bool(status & P.SERVER_MORE_RESULTS_EXISTS)
                break
            if pkt[0] == 0xFF:
                raise self._err(pkt)
            rows.append(self._decode_row(pkt, types, binary))
        return names, rows

    def _decode_row(self, pkt: bytes, types: List[int], binary: bool) -> Tuple:
        if not binary:
            out = []
            pos = 0
            for _ in types:
                if pkt[pos] == 0xFB:
                    out.append(None)
                    pos += 1
                else:
                    s, pos = P.read_lenenc_str(pkt, pos)
                    out.append(s.decode("utf8"))
            return tuple(out)
        n = len(types)
        null_bitmap = pkt[1:1 + (n + 7 + 2) // 8]
        pos = 1 + (n + 7 + 2) // 8
        out = []
        for i, t in enumerate(types):
            if null_bitmap[(i + 2) // 8] & (1 << ((i + 2) % 8)):
                out.append(None)
                continue
            if t == P.T_TINY:
                out.append(struct.unpack_from("<b", pkt, pos)[0])
                pos += 1
            elif t == P.T_SHORT:
                out.append(struct.unpack_from("<h", pkt, pos)[0])
                pos += 2
            elif t == P.T_LONG:
                out.append(struct.unpack_from("<i", pkt, pos)[0])
                pos += 4
            elif t == P.T_LONGLONG:
                out.append(struct.unpack_from("<q", pkt, pos)[0])
                pos += 8
            elif t == P.T_FLOAT:
                out.append(struct.unpack_from("<f", pkt, pos)[0])
                pos += 4
            elif t == P.T_DOUBLE:
                out.append(struct.unpack_from("<d", pkt, pos)[0])
                pos += 8
            elif t in (P.T_DATE, P.T_DATETIME, P.T_TIMESTAMP):
                ln = pkt[pos]
                pos += 1
                if ln >= 4:
                    y, m, d = struct.unpack_from("<HBB", pkt, pos)
                    s = f"{y:04d}-{m:02d}-{d:02d}"
                    if ln >= 7:
                        hh, mm, ss = struct.unpack_from("<BBB", pkt, pos + 4)
                        s += f" {hh:02d}:{mm:02d}:{ss:02d}"
                    out.append(s)
                else:
                    out.append(None)
                pos += ln
            else:
                s, pos = P.read_lenenc_str(pkt, pos)
                out.append(s.decode("utf8"))
        return tuple(out)

    def close(self):
        try:
            self._command(bytes([P.COM_QUIT]))
        except Exception:  # galaxylint: disable=swallow -- best-effort COM_QUIT on teardown; peer may already be gone
            pass
        self.sock.close()
