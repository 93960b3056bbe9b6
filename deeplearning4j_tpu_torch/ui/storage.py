"""StatsStorage backends (counterpart of `deeplearning4j_tpu/ui/storage.py`).

Reference: `api/storage/StatsStorage.java` (listener/router API),
`storage/mapdb/MapDBStatsStorage.java` and
`storage/sqlite/J7FileStatsStorage.java` (persistent), plus
`RemoteUIStatsStorageRouter` (HTTP POST to a UI on another process).
Here: in-memory, sqlite3 (stdlib; the JAX package's schema, so each
package reads the other's file), and an HTTP router posting the
binary-encoded reports to a UIServer's /remote endpoint.
"""

from __future__ import annotations

import contextlib
import sqlite3
import threading
from typing import Dict, List, Optional

from deeplearning4j_tpu_torch.ui.stats import StatsReport


class StatsStorage:
    def put_report(self, report: StatsReport) -> None:
        raise NotImplementedError

    def list_session_ids(self) -> List[str]:
        raise NotImplementedError

    def get_reports(self, session_id: str) -> List[StatsReport]:
        raise NotImplementedError

    def latest_report(self, session_id: str) -> Optional[StatsReport]:
        reports = self.get_reports(session_id)
        return reports[-1] if reports else None


class InMemoryStatsStorage(StatsStorage):
    def __init__(self):
        self._data: Dict[str, List[StatsReport]] = {}
        self._lock = threading.Lock()

    def put_report(self, report):
        with self._lock:
            self._data.setdefault(report.session_id, []).append(report)

    def list_session_ids(self):
        with self._lock:
            return list(self._data)

    def get_reports(self, session_id):
        with self._lock:
            return list(self._data.get(session_id, []))


class FileStatsStorage(StatsStorage):
    """sqlite-backed persistent storage (reference
    `J7FileStatsStorage.java` role). Reports are stored in the compact
    binary wire format, one commit a report. Each operation opens a
    connection, commits and closes it."""

    def __init__(self, path):
        self.path = str(path)
        self._lock = threading.Lock()
        self._execute("""CREATE TABLE IF NOT EXISTS reports (
                session_id TEXT, iteration INTEGER, payload BLOB,
                PRIMARY KEY (session_id, iteration))""")

    def _execute(self, sql, args=()):
        """Run one statement in its own connection (committed on
        success, rolled back on a raise, closed either way); its rows."""
        with self._lock, contextlib.closing(sqlite3.connect(self.path)) as c:
            with c:
                return c.execute(sql, args).fetchall()

    def put_report(self, report):
        self._execute("INSERT OR REPLACE INTO reports VALUES (?, ?, ?)",
                      (report.session_id, report.iteration, report.encode()))

    def list_session_ids(self):
        rows = self._execute("SELECT DISTINCT session_id FROM reports")
        return [r[0] for r in rows]

    def get_reports(self, session_id):
        rows = self._execute(
            "SELECT payload FROM reports WHERE session_id=? ORDER BY iteration",
            (session_id,))
        return [StatsReport.decode(r[0]) for r in rows]


class RemoteUIStatsStorageRouter(StatsStorage):
    """Train here, view there (reference
    `RemoteUIStatsStorageRouter.java`): POST binary reports to a
    UIServer's /remote endpoint."""

    def __init__(self, url: str):
        self.url = url.rstrip("/") + "/remote"

    def put_report(self, report):
        from urllib import request as urlrequest
        req = urlrequest.Request(
            self.url, data=report.encode(),
            headers={"Content-Type": "application/octet-stream"})
        with urlrequest.urlopen(req, timeout=30) as resp:  # noqa: S310 — user-configured UI host
            resp.read()

    def list_session_ids(self):
        return []

    def get_reports(self, session_id):
        return []
