"""Browser chat UI served at GET / — the Streamlit-frontend equivalent.

A copy of ``financial_rag_system_tpu/serving/ui.py``.

Feature parity with reference frontend.py: dark chat layout, backend
health badge (frontend.py:79-85), ticker input (fixed AAPL default,
frontend.py:69), top_k slider 1-10 default 5 (frontend.py:88), POST /ask
with a 95 s client timeout (frontend.py:133-139), sources expander with
sigmoid-normalized reranker score bars (frontend.py:112-117, 161-167),
and in-session chat history.  Plain HTML/JS with zero build step, served
straight from the backend process.
"""

PAGE = r"""<!doctype html>
<html>
<head>
<meta charset="utf-8">
<title>Financial RAG (TPU)</title>
<style>
  :root { --bg:#101418; --panel:#1a2026; --text:#e8eaed; --dim:#9aa0a6;
          --accent:#4f8ef7; --ok:#34a853; --bad:#ea4335; }
  body { background:var(--bg); color:var(--text); margin:0;
         font:15px/1.5 -apple-system, "Segoe UI", Roboto, sans-serif; }
  header { display:flex; gap:12px; align-items:center; padding:14px 22px;
           background:var(--panel); position:sticky; top:0; }
  header h1 { font-size:17px; margin:0; flex:1; }
  .badge { padding:3px 10px; border-radius:12px; font-size:12px; }
  .ok { background:var(--ok); } .bad { background:var(--bad); }
  main { max-width:860px; margin:0 auto; padding:20px; }
  .msg { padding:12px 16px; margin:10px 0; border-radius:10px; white-space:pre-wrap; }
  .user { background:#243041; margin-left:15%; }
  .bot  { background:var(--panel); margin-right:10%; }
  .meta { color:var(--dim); font-size:12px; margin-top:6px; }
  details { margin-top:8px; } summary { cursor:pointer; color:var(--dim); }
  .src { margin:8px 0; padding:8px; background:#12171c; border-radius:8px;
         font-size:13px; }
  .bar { height:6px; background:#2a3138; border-radius:3px; margin-top:4px; }
  .bar > div { height:100%; background:var(--accent); border-radius:3px; }
  footer { position:sticky; bottom:0; background:var(--panel); padding:14px 22px; }
  .row { display:flex; gap:10px; max-width:860px; margin:0 auto; }
  input[type=text] { flex:1; background:#0d1117; color:var(--text);
       border:1px solid #2a3138; border-radius:8px; padding:10px 12px; }
  #ticker { width:90px; flex:none; text-transform:uppercase; }
  button { background:var(--accent); color:white; border:none;
           border-radius:8px; padding:10px 18px; cursor:pointer; }
  button:disabled { opacity:.5; }
  label { color:var(--dim); font-size:13px; display:flex; align-items:center; gap:6px; }
</style>
</head>
<body>
<header>
  <h1>Financial RAG — TPU-native</h1>
  <label>top_k <input id="topk" type="range" min="1" max="10" value="5"
      oninput="document.getElementById('topkv').textContent=this.value">
    <span id="topkv">5</span></label>
  <span id="health" class="badge bad">checking…</span>
</header>
<main id="chat"></main>
<footer>
  <div class="row">
    <input id="ticker" type="text" value="AAPL">
    <input id="q" type="text" placeholder="Ask about a filing…"
           onkeydown="if(event.key==='Enter')ask()">
    <button id="send" onclick="ask()">Send</button>
  </div>
</footer>
<script>
const chat = document.getElementById('chat');
function add(cls, text) {
  const d = document.createElement('div');
  d.className = 'msg ' + cls; d.textContent = text;
  chat.appendChild(d); window.scrollTo(0, document.body.scrollHeight);
  return d;
}
const sigmoid = x => 1 / (1 + Math.exp(-x));
async function health() {
  const el = document.getElementById('health');
  try {
    const r = await fetch('/ready'); const j = await r.json();
    const ok = j.status === 'ready';
    el.className = 'badge ' + (ok ? 'ok' : 'bad');
    el.textContent = ok ? `ready · ${j.indexed_chunks ?? '?'} chunks` : 'not ready';
  } catch { el.className = 'badge bad'; el.textContent = 'offline'; }
}
health(); setInterval(health, 10000);
async function ask() {
  const q = document.getElementById('q').value.trim();
  const ticker = document.getElementById('ticker').value.trim().toUpperCase() || 'AAPL';
  const top_k = +document.getElementById('topk').value;
  if (!q) return;
  document.getElementById('q').value = '';
  add('user', `[${ticker}] ${q}`);
  const pending = add('bot', '…');
  const btn = document.getElementById('send'); btn.disabled = true;
  const ctrl = new AbortController();
  const timer = setTimeout(() => ctrl.abort(), 95000);
  try {
    const r = await fetch('/ask', {
      method: 'POST', headers: {'Content-Type': 'application/json'},
      body: JSON.stringify({query: q, ticker, top_k}), signal: ctrl.signal,
    });
    const j = await r.json();
    pending.textContent = j.answer ?? JSON.stringify(j);
    const meta = document.createElement('div');
    meta.className = 'meta';
    meta.textContent = `provider: ${j.provider}` + (j.cached ? ' · cached' : '');
    pending.appendChild(meta);
    if (j.sources && j.sources.length) {
      const det = document.createElement('details');
      det.innerHTML = `<summary>${j.sources.length} sources</summary>`;
      for (const s of j.sources) {
        const p = sigmoid(s.score);
        const div = document.createElement('div');
        div.className = 'src';
        div.innerHTML = `<div></div><div class="bar"><div style="width:${(100*p).toFixed(0)}%"></div></div>`;
        div.firstChild.textContent =
          `[${s.document_type}] ${s.text.slice(0, 300)}`;
        det.appendChild(div);
      }
      pending.appendChild(det);
    }
  } catch (e) { pending.textContent = '⚠️ request failed: ' + e; }
  finally { clearTimeout(timer); btn.disabled = false; }
}
</script>
</body>
</html>
"""
