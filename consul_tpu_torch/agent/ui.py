"""Built-in web UI: a single-file dashboard served at /ui; the port's copy
of ``consul_tpu/agent/ui.py`` (the page is byte for byte the same).

The reference ships an Ember.js SPA (``ui/packages/consul-ui``, ~11 MB
of JS, served when ``ui = true``); this is its small-footprint
counterpart — one self-contained HTML page that drives the same
``/v1`` HTTP API from the browser (services with health, nodes, KV
browser, members, datacenters), refreshing on an interval.  No build
step, no assets, no dependencies.
"""

UI_HTML = """<!DOCTYPE html>
<html lang="en">
<head>
<meta charset="utf-8">
<title>consul-tpu</title>
<style>
  :root { --ok:#2eb039; --warn:#c9a206; --crit:#c73445; --ink:#1f2430;
          --mut:#6b7280; --line:#e5e7eb; --bg:#f8f9fa; }
  * { box-sizing: border-box; }
  body { font: 14px/1.5 system-ui, sans-serif; margin:0; color:var(--ink);
         background:var(--bg); }
  header { background:#1f2430; color:#fff; padding:10px 20px;
           display:flex; gap:18px; align-items:baseline; }
  header h1 { font-size:16px; margin:0; }
  header .dc { color:#9aa3b2; font-size:12px; }
  nav button { background:none; border:none; color:#c8cedb; font:inherit;
               cursor:pointer; padding:4px 8px; border-radius:4px; }
  nav button.active { background:#3b4252; color:#fff; }
  main { max-width: 1000px; margin: 20px auto; padding: 0 16px; }
  table { width:100%; border-collapse:collapse; background:#fff;
          border:1px solid var(--line); border-radius:6px; }
  th, td { text-align:left; padding:8px 12px;
           border-bottom:1px solid var(--line); }
  th { color:var(--mut); font-weight:600; font-size:12px;
       text-transform:uppercase; }
  .dot { display:inline-block; width:9px; height:9px; border-radius:50%;
         margin-right:6px; }
  .passing { background:var(--ok); } .warning { background:var(--warn); }
  .critical { background:var(--crit); } .unknown { background:#9ca3af; }
  .mut { color:var(--mut); } code { background:#eef1f4; padding:1px 5px;
         border-radius:3px; }
</style>
</head>
<body>
<header>
  <h1>consul-tpu</h1>
  <nav id="nav"></nav>
  <span class="dc" id="meta"></span>
</header>
<main><div id="view">loading…</div></main>
<script>
const TABS = ["services", "nodes", "kv", "members", "datacenters"];
let tab = location.hash.slice(1) || "services";
const $ = (id) => document.getElementById(id);
const esc = (s) => String(s).replace(/[&<>"]/g,
  (c) => ({"&":"&amp;","<":"&lt;",">":"&gt;",'"':"&quot;"}[c]));
const get = (p) => fetch(p).then((r) => r.ok ? r.json() : []);
function worst(checks) {
  const st = (checks || []).map((c) => c.Status);
  if (st.includes("critical")) return "critical";
  if (st.includes("warning")) return "warning";
  return st.length ? "passing" : "unknown";
}
function table(head, rows) {
  return "<table><tr>" + head.map((h) => `<th>${h}</th>`).join("") +
    "</tr>" + rows.map((r) =>
      "<tr>" + r.map((c) => `<td>${c}</td>`).join("") + "</tr>"
    ).join("") + "</table>";
}
const views = {
  async services() {
    const svcs = await get("/v1/catalog/services");
    const rows = await Promise.all(Object.keys(svcs).map(async (name) => {
      const inst = await get(`/v1/health/service/${name}?stale`);
      const s = worst(inst.flatMap((i) => i.Checks || []));
      return [`<span class="dot ${s}"></span>${esc(name)}`,
              inst.length,
              (svcs[name] || []).map(esc).join(", ") || "—"];
    }));
    return table(["Service", "Instances", "Tags"], rows);
  },
  async nodes() {
    const nodes = await get("/v1/catalog/nodes?stale");
    return table(["Node", "Address"], nodes.map(
      (n) => [esc(n.Name || n.Node), `<code>${esc(n.Address)}</code>`]));
  },
  async kv() {
    const keys = await get("/v1/kv/?keys&stale") || [];
    return table(["Key"], keys.map((k) => [`<code>${esc(k)}</code>`]));
  },
  async members() {
    const ms = await get("/v1/agent/members");
    // Status is serf's MemberStatus int (none/alive/leaving/left/failed).
    const NAMES = ["none", "alive", "leaving", "left", "failed"];
    return table(["Member", "Address", "Status", "Type"], ms.map((m) => {
      const name = NAMES[m.Status] || String(m.Status);
      const s = name === "alive" ? "passing" : "critical";
      return [`<span class="dot ${s}"></span>${esc(m.Name)}`,
              `<code>${esc(m.Addr)}</code>`, esc(name),
              esc((m.Tags || {}).role || "client")];
    }));
  },
  async datacenters() {
    const dcs = await get("/v1/catalog/datacenters");
    return table(["Datacenter (RTT order)"], dcs.map((d) => [esc(d)]));
  },
};
function nav() {
  $("nav").innerHTML = TABS.map((t) =>
    `<button class="${t === tab ? "active" : ""}"
      onclick="location.hash='${t}'">${t}</button>`).join("");
}
async function render() {
  nav();
  try { $("view").innerHTML = await views[tab](); }
  catch (e) { $("view").innerHTML = `<p class="mut">${esc(e)}</p>`; }
  const self = await get("/v1/agent/self");
  $("meta").textContent =
    `${self?.Config?.NodeName || ""} · ${self?.Config?.Datacenter || ""}`;
}
window.addEventListener("hashchange", () => {
  tab = location.hash.slice(1) || "services"; render();
});
render();
setInterval(render, 5000);
</script>
</body>
</html>
"""
