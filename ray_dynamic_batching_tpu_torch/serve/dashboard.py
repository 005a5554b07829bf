"""Dashboard — HTTP state/metrics surface with a minimal HTML front end.

Re-creates the reference's dashboard head (``python/ray/dashboard/head.py:61``
aiohttp server + per-module backends + React client) at the scale this
framework needs: a threaded HTTP server exposing

- ``GET /``            auto-refreshing HTML view (deployments, replicas,
                       queue SLO table)
- ``GET /api/state``   full cluster state JSON (StateAPI.summary)
- ``GET /metrics``     Prometheus text exposition

The heavy lifting (state aggregation) lives in
:class:`ray_dynamic_batching_tpu_torch.state.StateAPI`; this module is transport.

Own copy of ``ray_dynamic_batching_tpu/serve/dashboard.py`` with its
import paths rewritten, whole (the page keeps the reference's title).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ray_dynamic_batching_tpu_torch.serve.proxy import _to_jsonable
from ray_dynamic_batching_tpu_torch.state import StateAPI
from ray_dynamic_batching_tpu_torch.utils.logging import get_logger

logger = get_logger("dashboard")

_PAGE = """<!doctype html>
<html><head><title>rdb-tpu dashboard</title>
<style>
 body { font-family: monospace; margin: 2em; background: #111; color: #ddd; }
 table { border-collapse: collapse; margin: 1em 0; }
 td, th { border: 1px solid #444; padding: 4px 10px; text-align: left; }
 th { background: #222; }
 .ok { color: #7c4; } .warning { color: #fb3; } .CRITICAL { color: #f55; }
 h2 { color: #8ac; }
 .timeline { position: relative; height: 22px; margin: 0.5em 0;
             background: #1a1a1a; border: 1px solid #444; }
 .tl { position: absolute; top: 2px; font-size: 14px; cursor: default; }
 .tl.rate_change { color: #fb3; } .tl.quarantine, .tl.heal { color: #f55; }
 .tl.manual, .tl.deploy, .tl.scale { color: #7c4; }
 .tl.rolling_update, .tl.health { color: #8ac; }
 td.diff { max-width: 40em; overflow-wrap: anywhere; }
</style></head>
<body>
<h1>ray_dynamic_batching_tpu_torch</h1>
<div id="root">loading...</div>
<script>
function esc(v) {  // names/ids are arbitrary strings: escape before innerHTML
  return String(v).replace(/[&<>"']/g,
    c => ({'&':'&amp;','<':'&lt;','>':'&gt;','"':'&quot;',"'":'&#39;'}[c]));
}
async function tick() {
  try {
    const s = await (await fetch('/api/state')).json();
    const thr = s.slo_thresholds ?? {good: 0.98, warn: 0.95};
    let html = '';
    if (s.deployments.length) {
      html += '<h2>deployments</h2><table><tr><th>name</th><th>replicas</th>'
            + '<th>target</th><th>healthy</th></tr>';
      for (const d of s.deployments)
        html += `<tr><td>${esc(d.name)}</td><td>${d.running_replicas ?? ''}</td>`
              + `<td>${d.target_replicas ?? d.num_replicas ?? ''}</td>`
              + `<td>${d.healthy ?? true}</td></tr>`;
      html += '</table>';
    }
    if (s.replicas.length) {
      html += '<h2>replicas</h2><table><tr><th>deployment</th><th>id</th>'
            + '<th>healthy</th><th>queue</th><th>accepting</th></tr>';
      for (const r of s.replicas)
        html += `<tr><td>${esc(r.deployment)}</td><td>${esc(r.replica_id)}</td>`
              + `<td>${r.healthy}</td><td>${r.queue_len}</td>`
              + `<td>${r.accepting}</td></tr>`;
      html += '</table>';
    }
    const queues = Object.entries(s.queues ?? {});
    if (queues.length) {
      html += '<h2>queues (SLO)</h2><table><tr><th>model</th><th>p95 ms</th>'
            + '<th>p99 ms</th><th>depth</th><th>SLO %</th><th>status</th></tr>';
      for (const [name, q] of queues) {
        const c = q.slo_compliance ?? 1;
        const st = c >= thr.good ? 'ok' : c >= thr.warn ? 'warning' : 'CRITICAL';
        html += `<tr><td>${esc(name)}</td><td>${(q.latency_p95_ms??0).toFixed(1)}</td>`
              + `<td>${(q.latency_p99_ms??0).toFixed(1)}</td><td>${q.depth??0}</td>`
              + `<td class="${st}">${(c*100).toFixed(1)}%</td>`
              + `<td class="${st}">${st}</td></tr>`;
      }
      html += '</table>';
    }
    const obs = s.observatory ?? {};
    const alerts = Object.entries(obs.alerts?.states ?? {});
    if (alerts.length) {
      // SLO observatory: burn-rate alert machine per (deployment/qos).
      html += '<h2>SLO observatory (burn-rate alerts)</h2>'
            + '<table><tr><th>deployment/qos</th><th>state</th>'
            + '<th>fast burn</th><th>slow burn</th></tr>';
      for (const [key, a] of alerts) {
        const st = a.state === 'ok' ? 'ok'
                 : a.state === 'page' ? 'CRITICAL' : 'warning';
        html += `<tr><td>${esc(key)}</td>`
              + `<td class="${st}">${esc(a.state)}</td>`
              + `<td>${a.fast_burn == null ? '—' : a.fast_burn.toFixed(2)}</td>`
              + `<td>${a.slow_burn == null ? '—' : a.slow_burn.toFixed(2)}</td>`
              + `</tr>`;
      }
      html += '</table>';
    }
    const fc = Object.entries(obs.forecast ?? {});
    if (fc.length) {
      html += '<h2>arrival forecast error</h2><table><tr><th>model</th>'
            + '<th>scored</th><th>refused</th><th>p50 |err| rps</th>'
            + '<th>p95 |err| rps</th></tr>';
      for (const [name, f] of fc)
        html += `<tr><td>${esc(name)}</td><td>${f.scored}</td>`
              + `<td>${f.refused}</td>`
              + `<td>${f.p50_abs_err_rps == null ? '—' : f.p50_abs_err_rps.toFixed(2)}</td>`
              + `<td>${f.p95_abs_err_rps == null ? '—' : f.p95_abs_err_rps.toFixed(2)}</td></tr>`;
      html += '</table>';
    }
    const fid = Object.entries(obs.fidelity?.last?.models ?? {});
    if (fid.length) {
      html += '<h2>sim-fidelity drift</h2><table><tr><th>model</th>'
            + '<th>drifting hops</th><th>ungraded</th></tr>';
      for (const [name, r] of fid) {
        const bad = (r.drifting_hops ?? []).join(', ');
        html += `<tr><td>${esc(name)}</td>`
              + `<td class="${bad ? 'CRITICAL' : 'ok'}">${esc(bad || 'none')}</td>`
              + `<td>${esc(Object.keys(r.ungraded ?? {}).join(', '))}</td></tr>`;
      }
      html += '</table>';
    }
    const audit = s.audit ?? [];
    if (audit.length) {
      // Replan timeline: one marker per decision, positioned by wall time
      // over the window the ring covers, colored by trigger.
      html += '<h2>scheduler audit (replans &amp; control decisions)</h2>';
      const t0 = audit[0].wall_time, t1 = audit[audit.length - 1].wall_time;
      const span = Math.max(1e-9, t1 - t0);
      html += '<div class="timeline">' + audit.map(a => {
        const left = ((a.wall_time - t0) / span * 97).toFixed(2);
        const tip = `${new Date(a.wall_time * 1000).toLocaleTimeString()} `
                  + `${a.domain}/${a.trigger} ${a.key ?? ''}`;
        return `<span class="tl ${esc(a.trigger)}" style="left:${left}%"`
             + ` title="${esc(tip)}">&#9679;</span>`;
      }).join('') + '</div>';
      html += '<table><tr><th>time</th><th>domain</th><th>trigger</th>'
            + '<th>key</th><th>cost</th><th>old &rarr; new</th></tr>';
      for (const a of audit.slice(-12).reverse()) {
        const d = a.diff ?? {};
        let change;
        if (d.engines_changed !== undefined) {
          change = Object.entries(d.engines_changed).map(([e, c]) =>
            `engine${e}: [${(c.old ?? []).join(' ')}] → `
            + `[${(c.new ?? []).join(' ')}]`).join('; ')
            || 'no movement';
        } else {
          change = Object.entries(d).map(([k, v]) =>
            `${k}=${JSON.stringify(v)}`).join(', ') || (a.note ?? '');
        }
        html += `<tr><td>${new Date(a.wall_time * 1000).toLocaleTimeString()}`
              + `</td><td>${esc(a.domain)}</td><td>${esc(a.trigger)}</td>`
              + `<td>${esc(a.key ?? '')}</td>`
              + `<td>${(a.migration_cost ?? 0).toFixed(1)}</td>`
              + `<td class="diff">${esc(change)}</td></tr>`;
      }
      html += '</table>';
    }
    document.getElementById('root').innerHTML = html || 'no state yet';
  } catch (e) {
    document.getElementById('root').innerHTML = 'fetch failed: ' + esc(e);
  }
}
tick(); setInterval(tick, 2000);
</script>
</body></html>
"""


class DashboardServer:
    """Threaded HTTP server over a StateAPI (default bind 127.0.0.1:8265 —
    the reference dashboard's port)."""

    def __init__(self, state: StateAPI, host: str = "127.0.0.1",
                 port: int = 8265) -> None:
        self.state = state
        dashboard = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # route to framework logger
                logger.debug("dashboard: " + fmt, *args)

            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 - http.server API
                try:
                    if self.path == "/" or self.path == "/index.html":
                        self._send(200, _PAGE.encode(), "text/html")
                    elif self.path == "/api/state":
                        body = json.dumps(
                            _to_jsonable(dashboard.state.summary())
                        ).encode()
                        self._send(200, body, "application/json")
                    elif self.path == "/metrics":
                        # Same negotiation as the proxy: exemplars only on
                        # the OpenMetrics grammar.
                        accept = self.headers.get("Accept", "") or ""
                        if "application/openmetrics-text" in accept:
                            self._send(
                                200,
                                dashboard.state.registry
                                .openmetrics_text().encode(),
                                "application/openmetrics-text; "
                                "version=1.0.0; charset=utf-8",
                            )
                        else:
                            self._send(
                                200, dashboard.state.metrics_text().encode(),
                                "text/plain; version=0.0.4",
                            )
                    elif self.path == "/-/healthz":
                        self._send(200, b"ok", "text/plain")
                    else:
                        self._send(404, b"not found", "text/plain")
                except Exception as e:  # noqa: BLE001 — keep serving
                    logger.warning("dashboard handler error: %s", e)
                    try:
                        self._send(500, str(e).encode(), "text/plain")
                    except Exception:  # noqa: BLE001 — client gone
                        pass

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> "DashboardServer":
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="dashboard", daemon=True
        )
        self._thread.start()
        logger.info("dashboard listening on :%d", self.port)
        return self

    def stop(self) -> None:
        # shutdown() blocks forever unless serve_forever() is running
        if self._thread is not None:
            self._server.shutdown()
            self._thread.join(timeout=5)
            self._thread = None
        self._server.server_close()
