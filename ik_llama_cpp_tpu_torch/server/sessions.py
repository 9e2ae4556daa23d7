"""Server-side session store (--sql-save-file).

The reference server persists WebUI chat sessions in a sqlite database
behind /load /save /rename /all /sessions /delete /vacuum
(server.cpp:1987-2046, gated on params.sql_save_file). Two key/value
tables: ``sessions`` holds JSON documents, ``names`` holds display names;
store names in requests are normalized to lowercase letters
(server.cpp:1967 normalize_store_name) so arbitrary table names can't be
injected. The reference's optional sqlite-zstd transparent compression is
an extension feature we don't mirror (/version reports it false).

The torch port's copy of the JAX package's ``server/sessions.py``: numpy and the
standard library only, held to the JAX module by
``tests/test_torch_server_extras.py``.
"""
from __future__ import annotations

import json
import sqlite3
import threading


def normalize_store_name(name) -> str:
    if not isinstance(name, str):
        return "sessions"
    out = "".join(c.lower() for c in name if c.isalpha())
    return out or "sessions"


class SessionDB:
    def __init__(self, path: str):
        self.path = path
        # aiohttp handlers run on the event loop; sqlite ops here are
        # microseconds, so a single cross-thread connection + lock suffices
        self.conn = sqlite3.connect(path, check_same_thread=False)
        self.lock = threading.Lock()
        with self.lock:
            for table in ("sessions", "names"):
                self.conn.execute(
                    f"CREATE TABLE IF NOT EXISTS {table} "
                    "(key TEXT PRIMARY KEY, data TEXT)")
            self.conn.commit()

    @staticmethod
    def _key(k) -> str:
        return k if isinstance(k, str) else json.dumps(k)

    def _ensure(self, store: str) -> None:
        """Create a store's table on first use (normalize_store_name admits
        any alphabetic name, not just the two pre-created tables); caller
        holds self.lock."""
        self.conn.execute(f"CREATE TABLE IF NOT EXISTS {store} "
                          "(key TEXT PRIMARY KEY, data TEXT)")

    def load(self, store, key):
        """Returns the parsed document, the raw name string for the names
        store, or None when absent."""
        store = normalize_store_name(store)
        with self.lock:
            self._ensure(store)
            row = self.conn.execute(
                f"SELECT data FROM {store} WHERE key = ?",
                (self._key(key),)).fetchone()
        if row is None or not row[0]:
            return None
        return row[0] if store == "names" else json.loads(row[0])

    def save(self, store, key, data) -> None:
        store = normalize_store_name(store)
        text = data if store == "names" and isinstance(data, str) \
            else json.dumps(data)
        with self.lock:
            self._ensure(store)
            self.conn.execute(
                f"INSERT OR REPLACE INTO {store} (key, data) VALUES (?, ?)",
                (self._key(key), text))
            self.conn.commit()

    def rename(self, key, new_name: str) -> None:
        with self.lock:
            self.conn.execute("UPDATE names SET data = ? WHERE key = ?",
                              (new_name, self._key(key)))
            self.conn.commit()

    def all(self, store) -> dict:
        store = normalize_store_name(store)
        with self.lock:
            self._ensure(store)
            rows = self.conn.execute(
                f"SELECT key, data FROM {store}").fetchall()
        return {k: json.loads(d) for k, d in rows}

    def sessions(self) -> dict:
        """{key: display name} from the names table."""
        with self.lock:
            rows = self.conn.execute("SELECT key, data FROM names").fetchall()
        return dict(rows)

    def delete(self, store, key) -> None:
        store = normalize_store_name(store)
        with self.lock:
            self._ensure(store)
            self.conn.execute(f"DELETE FROM {store} WHERE key = ?",
                              (self._key(key),))
            self.conn.commit()

    def vacuum(self) -> None:
        with self.lock:
            self.conn.execute("VACUUM")

    def close(self) -> None:
        with self.lock:
            self.conn.close()
