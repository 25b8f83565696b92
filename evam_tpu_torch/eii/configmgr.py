"""ConfigMgr: the EII ConfigManager counterpart.

Counterpart of ``evam_tpu/eii/configmgr.py`` (a copy; the reference's
module is standard library only). The reference service reads its
config from etcd through the EII ConfigManager C binding. Two backends
behind the same API:

* **file** (default): a local JSON file with the same two-section
  shape as the reference's eii/config.json (``config`` +
  ``interfaces``), mtime-poll watcher;
* **etcd** (``EVAM_ETCD_HOST``/``ETCD_HOST`` set): the etcd v3
  gRPC-gateway HTTP/JSON API (`POST /v3/kv/range`) with keys
  ``{ETCD_PREFIX}/config`` and ``{ETCD_PREFIX}/interfaces``
  (``ETCD_CLIENT_PORT``, 2379), mod_revision-poll watcher, optional
  TLS via ``CONFIGMGR_CACERT``/``CONFIGMGR_CERT``/``CONFIGMGR_KEY``.

Both deliver working hot-reload callbacks, and a dead etcd falls back
to the file store so boot never blocks on the control plane.
"""

from __future__ import annotations

import base64
import json
import logging
import os
import ssl
import threading
import urllib.request
from pathlib import Path
from typing import Any, Callable

log = logging.getLogger("evam_tpu_torch.eii.configmgr")

DEFAULT_CONFIG: dict[str, Any] = {
    "config": {
        "source": "gstreamer",
        "pipeline": "object_detection/person_vehicle_bike",
        "source_parameters": {
            "type": "uri",
            "uri": "synthetic://768x432@30",
        },
        "publish_frame": False,
        "encoding": {"type": "jpeg", "level": 95},
        "model_parameters": {},
    },
    "interfaces": {
        "Publishers": [
            {
                "Name": "default",
                "Type": "zmq_tcp",
                "EndPoint": "0.0.0.0:65114",
                "Topics": ["camera1_stream_results"],
                "AllowedClients": ["*"],
            }
        ],
        "Subscribers": [],
    },
}


class EtcdGatewayStore:
    """etcd v3 HTTP/JSON gateway client (stdlib-only).

    Reads ``{prefix}/config`` and ``{prefix}/interfaces`` (JSON
    values — the layout the reference provisions per-app into etcd).
    ``version()`` is the max mod_revision, the etcd analogue of the
    file store's mtime.
    """

    def __init__(
        self,
        host: str,
        port: int = 2379,
        prefix: str = "/evam_tpu",
        cacert: str | None = None,
        cert: str | None = None,
        key: str | None = None,
        timeout_s: float = 5.0,
    ):
        # TLS keys on ANY of the cert vars — client-cert-only (CA in
        # the system trust store) must not silently downgrade to http
        use_tls = bool(cacert or cert or key)
        scheme = "https" if use_tls else "http"
        self.base = f"{scheme}://{host}:{port}"
        self.prefix = prefix.rstrip("/")
        self.timeout_s = timeout_s
        self._ctx: ssl.SSLContext | None = None
        if use_tls:
            self._ctx = ssl.create_default_context(
                cafile=cacert if cacert else None)
            if cert and key:
                self._ctx.load_cert_chain(cert, key)

    def _range(self, key: str) -> tuple[dict | None, int]:
        payload = json.dumps(
            {"key": base64.b64encode(key.encode()).decode()}
        ).encode()
        req = urllib.request.Request(
            f"{self.base}/v3/kv/range", data=payload,
            headers={"Content-Type": "application/json"}, method="POST",
        )
        with urllib.request.urlopen(
            req, timeout=self.timeout_s, context=self._ctx
        ) as resp:
            body = json.loads(resp.read())
        kvs = body.get("kvs") or []
        if not kvs:
            return None, 0
        value = json.loads(base64.b64decode(kvs[0]["value"]))
        return value, int(kvs[0].get("mod_revision", 0))

    def load(self) -> dict[str, Any]:
        data: dict[str, Any] = {}
        cfg, _ = self._range(f"{self.prefix}/config")
        ifaces, _ = self._range(f"{self.prefix}/interfaces")
        if cfg is None and ifaces is None:
            # single-document fallback: the whole config.json at the prefix
            doc, _ = self._range(self.prefix)
            if doc is None:
                raise KeyError(
                    f"no config at etcd keys {self.prefix}[/config]"
                )
            return doc
        if cfg is not None:
            data["config"] = cfg
        if ifaces is not None:
            data["interfaces"] = ifaces
        return data

    def version(self) -> float:
        revs = []
        for key in (f"{self.prefix}/config", f"{self.prefix}/interfaces",
                    self.prefix):
            try:
                _, rev = self._range(key)
                revs.append(rev)
            except Exception:  # noqa: BLE001 — transient gateway error
                return -1.0  # forces no-change (retry next poll)
        return float(max(revs))

    @classmethod
    def from_env(cls, env=os.environ) -> "EtcdGatewayStore | None":
        host = env.get("EVAM_ETCD_HOST") or env.get("ETCD_HOST")
        if not host:
            return None
        return cls(
            host=host,
            port=int(env.get("ETCD_CLIENT_PORT", "2379")),
            prefix=env.get("ETCD_PREFIX", "/evam_tpu"),
            cacert=env.get("CONFIGMGR_CACERT") or None,
            cert=env.get("CONFIGMGR_CERT") or None,
            key=env.get("CONFIGMGR_KEY") or None,
        )


class ConfigMgr:
    def __init__(
        self,
        config_file: str | Path | None = None,
        watch_interval_s: float = 2.0,
        etcd: EtcdGatewayStore | None = None,
    ):
        self.config_file = Path(config_file) if config_file else None
        self.watch_interval_s = watch_interval_s
        self.etcd = etcd if etcd is not None else EtcdGatewayStore.from_env()
        if self.etcd is not None:
            try:
                self._data = self.etcd.load()
                self._mtime = self.etcd.version()
                log.info("config from etcd gateway %s (rev %d)",
                         self.etcd.base, int(self._mtime))
            except Exception as exc:  # noqa: BLE001 — dead control plane
                log.warning(
                    "etcd gateway %s unavailable (%s); falling back to "
                    "file store", self.etcd.base, exc,
                )
                self.etcd = None
        if self.etcd is None:
            self._data = self._load()
            self._mtime = self._stat_mtime()
        self._watcher: threading.Thread | None = None
        self._stop = threading.Event()
        self._callbacks: list[Callable[[dict], None]] = []

    def _load(self) -> dict[str, Any]:
        if self.etcd is not None:
            return self.etcd.load()
        if self.config_file and self.config_file.exists():
            return json.loads(self.config_file.read_text())
        return json.loads(json.dumps(DEFAULT_CONFIG))  # deep copy

    def _stat_mtime(self) -> float:
        if self.etcd is not None:
            return self.etcd.version()
        try:
            return self.config_file.stat().st_mtime if self.config_file else 0.0
        except OSError:
            return 0.0

    # ---------------------------------------------------- reference API

    def get_app_config(self) -> dict[str, Any]:
        """App-level config (reference get_app_config().get_dict())."""
        return self._data.get("config", {})

    def get_num_publishers(self) -> int:
        return len(self._data.get("interfaces", {}).get("Publishers", []))

    def get_num_subscribers(self) -> int:
        return len(self._data.get("interfaces", {}).get("Subscribers", []))

    def get_publisher_by_index(self, i: int) -> dict[str, Any]:
        return self._data["interfaces"]["Publishers"][i]

    def get_subscriber_by_index(self, i: int) -> dict[str, Any]:
        return self._data["interfaces"]["Subscribers"][i]

    # -------------------------------------------------------- watching

    def watch(self, callback: Callable[[dict], None]) -> None:
        """Hot-reload hook (working version of the reference's stubbed
        `_config_update_callback`)."""
        self._callbacks.append(callback)
        watchable = self.config_file is not None or self.etcd is not None
        if self._watcher is None and watchable:
            self._watcher = threading.Thread(
                target=self._watch_loop, name="configmgr-watch", daemon=True
            )
            self._watcher.start()

    def _watch_loop(self) -> None:
        while not self._stop.wait(self.watch_interval_s):
            mtime = self._stat_mtime()
            if mtime < 0:
                continue  # transient etcd gateway error: retry next poll
            if mtime != self._mtime:
                try:
                    self._data = self._load()
                except Exception as exc:  # noqa: BLE001 — bad file/gateway blip
                    # do NOT commit mtime: unlike the file store (whose
                    # mtime changes again on the next edit), an etcd
                    # revision only moves on writes — committing before
                    # a successful load would drop this update forever
                    log.warning("config reload failed: %s", exc)
                    continue
                self._mtime = mtime
                log.info("config file changed; notifying %d watcher(s)",
                         len(self._callbacks))
                for cb in self._callbacks:
                    try:
                        cb(self._data)
                    except Exception as exc:  # noqa: BLE001
                        log.warning("config callback error: %s", exc)

    def close(self) -> None:
        self._stop.set()
