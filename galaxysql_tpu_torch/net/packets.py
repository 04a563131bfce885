"""MySQL client/server protocol packet codec.

Reference analog: `polardbx-net/src/main/java/.../net/packet` (SURVEY.md §2.1) —
handshake v10, auth, COM_* commands, OK/ERR/EOF, column definitions, textual and binary
resultset rows.  Pure codec; transport lives in `net/server.py` (asyncio replaces the
reference's NIO reactor threads, §7.1 stance).
"""

from __future__ import annotations

import hashlib
import struct
from typing import Any, Iterable, List, Optional, Sequence, Tuple

from galaxysql_tpu_torch.types import datatype as dt

PROTOCOL_VERSION = 10
SERVER_VERSION = b"8.0.3-galaxysql-tpu"
CHARSET_UTF8MB4 = 255

# capability flags
CLIENT_LONG_PASSWORD = 1
CLIENT_FOUND_ROWS = 2
CLIENT_LONG_FLAG = 4
CLIENT_CONNECT_WITH_DB = 8
CLIENT_COMPRESS = 32
CLIENT_PROTOCOL_41 = 512
CLIENT_SSL = 2048
CLIENT_TRANSACTIONS = 8192
CLIENT_SECURE_CONNECTION = 32768
CLIENT_MULTI_STATEMENTS = 1 << 16
CLIENT_MULTI_RESULTS = 1 << 17
CLIENT_PLUGIN_AUTH = 1 << 19
CLIENT_DEPRECATE_EOF = 1 << 24

SERVER_CAPABILITIES = (CLIENT_LONG_PASSWORD | CLIENT_FOUND_ROWS | CLIENT_LONG_FLAG |
                       CLIENT_CONNECT_WITH_DB | CLIENT_COMPRESS | CLIENT_PROTOCOL_41 |
                       CLIENT_TRANSACTIONS | CLIENT_SECURE_CONNECTION |
                       CLIENT_MULTI_STATEMENTS | CLIENT_MULTI_RESULTS |
                       CLIENT_PLUGIN_AUTH)

# status flags
SERVER_STATUS_AUTOCOMMIT = 2
SERVER_STATUS_IN_TRANS = 1
SERVER_MORE_RESULTS_EXISTS = 8

# commands
COM_QUIT = 0x01
COM_INIT_DB = 0x02
COM_QUERY = 0x03
COM_FIELD_LIST = 0x04
COM_PING = 0x0E
COM_STMT_PREPARE = 0x16
COM_STMT_EXECUTE = 0x17
COM_STMT_SEND_LONG_DATA = 0x18
COM_STMT_CLOSE = 0x19
COM_STMT_RESET = 0x1A
COM_SET_OPTION = 0x1B
COM_BINLOG_DUMP = 0x12

# column type codes
T_DECIMAL = 0x00
T_TINY = 0x01
T_SHORT = 0x02
T_LONG = 0x03
T_FLOAT = 0x04
T_DOUBLE = 0x05
T_NULL = 0x06
T_TIMESTAMP = 0x07
T_LONGLONG = 0x08
T_DATE = 0x0A
T_TIME = 0x0B
T_DATETIME = 0x0C
T_VARCHAR = 0x0F
T_NEWDECIMAL = 0xF6
T_VAR_STRING = 0xFD
T_STRING = 0xFE


def mysql_type_of(t: dt.DataType) -> int:
    c = t.clazz
    if c == dt.TypeClass.DECIMAL:
        return T_NEWDECIMAL
    if c in (dt.TypeClass.INT, dt.TypeClass.UINT, dt.TypeClass.BOOL):
        return {1: T_TINY, 2: T_SHORT, 4: T_LONG, 8: T_LONGLONG}.get(
            t.lane.itemsize, T_LONGLONG)
    if c == dt.TypeClass.FLOAT:
        return T_DOUBLE if t.precision == 8 else T_FLOAT
    if c == dt.TypeClass.DATE:
        return T_DATE
    if c == dt.TypeClass.DATETIME:
        return T_DATETIME
    if c == dt.TypeClass.TIME:
        return T_TIME
    return T_VAR_STRING


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def lenenc_int(n: int) -> bytes:
    if n < 0xFB:
        return bytes([n])
    if n < (1 << 16):
        return b"\xfc" + struct.pack("<H", n)
    if n < (1 << 24):
        return b"\xfd" + struct.pack("<I", n)[:3]
    return b"\xfe" + struct.pack("<Q", n)


def read_lenenc_int(buf: bytes, pos: int) -> Tuple[int, int]:
    first = buf[pos]
    if first < 0xFB:
        return first, pos + 1
    if first == 0xFC:
        return struct.unpack_from("<H", buf, pos + 1)[0], pos + 3
    if first == 0xFD:
        return struct.unpack_from("<I", buf[pos + 1:pos + 4] + b"\0")[0], pos + 4
    return struct.unpack_from("<Q", buf, pos + 1)[0], pos + 9


def lenenc_str(s: bytes) -> bytes:
    return lenenc_int(len(s)) + s


def read_lenenc_str(buf: bytes, pos: int) -> Tuple[bytes, int]:
    n, pos = read_lenenc_int(buf, pos)
    return buf[pos:pos + n], pos + n


def native_password_scramble(password: bytes, seed: bytes) -> bytes:
    """mysql_native_password: SHA1(pw) XOR SHA1(seed + SHA1(SHA1(pw)))."""
    if not password:
        return b""
    h1 = hashlib.sha1(password).digest()
    h2 = hashlib.sha1(h1).digest()
    h3 = hashlib.sha1(seed + h2).digest()
    return bytes(a ^ b for a, b in zip(h1, h3))


# ---------------------------------------------------------------------------
# server -> client packets (payloads; framing added by the transport)
# ---------------------------------------------------------------------------

def handshake_v10(conn_id: int, seed: bytes, caps: int = 0) -> bytes:
    caps = caps or SERVER_CAPABILITIES
    out = bytearray()
    out.append(PROTOCOL_VERSION)
    out += SERVER_VERSION + b"\0"
    out += struct.pack("<I", conn_id)
    out += seed[:8] + b"\0"
    out += struct.pack("<H", caps & 0xFFFF)
    out.append(CHARSET_UTF8MB4)
    out += struct.pack("<H", SERVER_STATUS_AUTOCOMMIT)
    out += struct.pack("<H", (caps >> 16) & 0xFFFF)
    out.append(len(seed) + 1)
    out += b"\0" * 10
    out += seed[8:] + b"\0"
    out += b"mysql_native_password\0"
    return bytes(out)


def parse_handshake_response(payload: bytes) -> dict:
    caps = struct.unpack_from("<I", payload, 0)[0]
    pos = 4 + 4 + 1 + 23  # caps, max packet, charset, filler
    end = payload.index(b"\0", pos)
    user = payload[pos:end].decode("utf8", "replace")
    pos = end + 1
    if caps & CLIENT_SECURE_CONNECTION:
        alen = payload[pos]
        auth = payload[pos + 1:pos + 1 + alen]
        pos += 1 + alen
    else:
        end = payload.index(b"\0", pos)
        auth = payload[pos:end]
        pos = end + 1
    database = None
    if caps & CLIENT_CONNECT_WITH_DB and pos < len(payload):
        end = payload.find(b"\0", pos)
        if end < 0:
            end = len(payload)
        database = payload[pos:end].decode("utf8", "replace") or None
        pos = end + 1
    return {"capabilities": caps, "user": user, "auth": auth, "database": database}


def ok_packet(affected: int = 0, last_insert_id: int = 0,
              status: int = SERVER_STATUS_AUTOCOMMIT, warnings: int = 0,
              info: bytes = b"") -> bytes:
    return (b"\x00" + lenenc_int(affected) + lenenc_int(last_insert_id) +
            struct.pack("<HH", status, warnings) + info)


def err_packet(errno: int, sqlstate: str, message: str) -> bytes:
    return (b"\xff" + struct.pack("<H", errno) + b"#" +
            sqlstate.encode("ascii")[:5].ljust(5, b"0") +
            message.encode("utf8")[:512])


def eof_packet(status: int = SERVER_STATUS_AUTOCOMMIT, warnings: int = 0) -> bytes:
    return b"\xfe" + struct.pack("<HH", warnings, status)


def column_def(name: str, typ: dt.DataType, table: str = "",
               schema: str = "") -> bytes:
    tcode = mysql_type_of(typ)
    charset = CHARSET_UTF8MB4 if typ.is_string else 63  # 63 = binary
    length = 255 if typ.is_string else 21
    decimals = typ.scale if typ.clazz == dt.TypeClass.DECIMAL else 0
    out = bytearray()
    out += lenenc_str(b"def")
    out += lenenc_str(schema.encode("utf8"))
    out += lenenc_str(table.encode("utf8"))
    out += lenenc_str(table.encode("utf8"))
    out += lenenc_str(name.encode("utf8"))
    out += lenenc_str(name.encode("utf8"))
    out.append(0x0C)
    out += struct.pack("<H", charset)
    out += struct.pack("<I", length)
    out.append(tcode)
    out += struct.pack("<H", 0)  # flags
    out.append(decimals)
    out += b"\0\0"
    return bytes(out)


def text_value(v: Any) -> bytes:
    if v is None:
        return b"\xfb"
    if isinstance(v, bool):
        v = int(v)
    if isinstance(v, float):
        s = repr(v).encode("ascii")
    elif isinstance(v, bytes):
        s = v
    else:
        s = str(v).encode("utf8")
    return lenenc_str(s)


def text_row(values: Sequence[Any]) -> bytes:
    return b"".join(text_value(v) for v in values)


def binary_row(values: Sequence[Any], types: Sequence[dt.DataType]) -> bytes:
    """Binary-protocol resultset row (COM_STMT_EXECUTE responses)."""
    n = len(values)
    null_bitmap = bytearray((n + 7 + 2) // 8)
    body = bytearray()
    for i, (v, t) in enumerate(zip(values, types)):
        if v is None:
            null_bitmap[(i + 2) // 8] |= 1 << ((i + 2) % 8)
            continue
        code = mysql_type_of(t)
        if code in (T_TINY,):
            body += struct.pack("<b", int(v))
        elif code == T_SHORT:
            body += struct.pack("<h", int(v))
        elif code == T_LONG:
            body += struct.pack("<i", int(v))
        elif code == T_LONGLONG:
            body += struct.pack("<q", int(v))
        elif code == T_FLOAT:
            body += struct.pack("<f", float(v))
        elif code == T_DOUBLE:
            body += struct.pack("<d", float(v))
        elif code in (T_DATE, T_DATETIME, T_TIMESTAMP):
            body += _binary_datetime(str(v))
        else:  # decimals and strings travel as text
            body += lenenc_str(str(v).encode("utf8"))
    return b"\x00" + bytes(null_bitmap) + bytes(body)


def _binary_datetime(s: str) -> bytes:
    date_part, _, time_part = s.partition(" ")
    y, m, d = (int(x) for x in date_part.split("-"))
    if not time_part:
        return bytes([4]) + struct.pack("<HBB", y, m, d)
    hh, mm, ss = time_part.split(":")
    frac = 0
    if "." in ss:
        ss, f = ss.split(".")
        frac = int(f.ljust(6, "0"))
    if frac:
        return bytes([11]) + struct.pack("<HBBBBBI", y, m, d, int(hh), int(mm),
                                         int(ss), frac)
    return bytes([7]) + struct.pack("<HBBBBB", y, m, d, int(hh), int(mm), int(ss))


def parse_stmt_execute_params(payload: bytes, n_params: int,
                              known_types: Optional[List[Tuple[int, int]]] = None
                              ) -> Tuple[List[Any], List[Tuple[int, int]]]:
    """COM_STMT_EXECUTE: [stmt_id][flags][iter][null bitmap][new_params][types][values].

    Connectors send parameter types only on the FIRST execute (new_params_bound_flag);
    later executes reuse them — the caller caches `types` and passes `known_types`.
    Returns (values, types_used)."""
    pos = 1 + 4 + 1 + 4
    if n_params == 0:
        return [], []
    nb_len = (n_params + 7) // 8
    null_bitmap = payload[pos:pos + nb_len]
    pos += nb_len
    new_params = payload[pos]
    pos += 1
    params: List[Any] = [None] * n_params
    if new_params:
        types = []
        for i in range(n_params):
            types.append((payload[pos], payload[pos + 1]))
            pos += 2
    elif known_types is not None:
        types = known_types
    else:
        from galaxysql_tpu_torch.utils.errors import TddlError
        raise TddlError("malformed COM_STMT_EXECUTE: no parameter types bound")
    for i in range(n_params):
        if null_bitmap[i // 8] & (1 << (i % 8)):
            params[i] = None
            continue
        tcode, flags = types[i]
        unsigned = flags & 0x80
        if tcode == T_TINY:
            params[i] = payload[pos] if unsigned else \
                struct.unpack_from("<b", payload, pos)[0]
            pos += 1
        elif tcode == T_SHORT:
            params[i] = struct.unpack_from("<H" if unsigned else "<h", payload, pos)[0]
            pos += 2
        elif tcode == T_LONG:
            params[i] = struct.unpack_from("<I" if unsigned else "<i", payload, pos)[0]
            pos += 4
        elif tcode == T_LONGLONG:
            params[i] = struct.unpack_from("<Q" if unsigned else "<q", payload, pos)[0]
            pos += 8
        elif tcode == T_FLOAT:
            params[i] = struct.unpack_from("<f", payload, pos)[0]
            pos += 4
        elif tcode == T_DOUBLE:
            params[i] = struct.unpack_from("<d", payload, pos)[0]
            pos += 8
        elif tcode in (T_DATE, T_DATETIME, T_TIMESTAMP):
            ln = payload[pos]
            pos += 1
            if ln >= 4:
                y, m, d = struct.unpack_from("<HBB", payload, pos)
                val = f"{y:04d}-{m:02d}-{d:02d}"
                if ln >= 7:
                    hh, mm, ss = struct.unpack_from("<BBB", payload, pos + 4)
                    val += f" {hh:02d}:{mm:02d}:{ss:02d}"
                params[i] = val
            else:
                params[i] = "0000-00-00"
            pos += ln
        else:  # string-ish: lenenc
            s, pos = read_lenenc_str(payload, pos)
            params[i] = s.decode("utf8", "replace")
    return params, types
