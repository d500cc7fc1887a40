// OmniScribe TPU web client — from-scratch implementation of the reference
// SPA's workflows (reference public/static/app.js, 5,462 LoC): upload with
// SSE progress + orthography option, history with placeholder rows,
// rendering with speaker/language/emotion/chunk highlight modes, playback
// word-sync + segment navigation + loop, waveform + Praat-style mel
// spectrogram (pre-emphasis, auto max-freq, viewport cache) with formant +
// intensity overlays, zoom/selection/snippet export, segment & word
// boundary drag editing, undo/redo, IPA picker, citation box, and exports
// via the byte-compatible server-side exporters.
"use strict";

const $ = (sel) => document.querySelector(sel);

// ------------------------------------------------------------------ auth
// JWT shell: token kept in localStorage and injected as a Bearer header on
// every /api fetch; a 401 pops the login/register overlay. Servers running
// without --auth never return 401, so the overlay stays hidden.

const TOKEN_KEY = "omniasr_token";
const _fetch = window.fetch.bind(window);

// ---- wav2elan shell (reference workflows/wav2elan_web/static/app.js) ----
// The reference ships a SECOND frontend: no accounts — a per-browser
// 12-char session key rides every /api call as x-session-key (:1-33), and
// a client-side password modal gates transcription (:114-178). Served at
// /wav2elan with window.OMNI_SHELL set; the JWT shell below stays the
// default at /.
const WAV2ELAN = window.OMNI_SHELL === "wav2elan";
const W2E_PASSWORD = "sesquip";

function sessionKey() {
  let key = localStorage.getItem("omni_session_key");
  if (!key) {
    const chars =
      "ABCDEFGHJKLMNPQRSTUVWXYZabcdefghjkmnpqrstuvwxyz23456789";
    const arr = new Uint8Array(12);
    crypto.getRandomValues(arr);
    key = Array.from(arr, (b) => chars[b % chars.length]).join("");
    localStorage.setItem("omni_session_key", key);
  }
  return key;
}

let w2eGateResolve = null;

function w2eGate() {
  // Resolves once the user has entered the gate password (kept for the
  // tab in sessionStorage, reference :115).
  if (sessionStorage.getItem("authenticated") === "true") {
    return Promise.resolve();
  }
  $("#password-modal").hidden = false;
  $("#password-input").focus();
  return new Promise((resolve) => { w2eGateResolve = resolve; });
}

window.fetch = (url, opts = {}) => {
  const u = String(url);
  if (WAV2ELAN) {
    let gate = Promise.resolve();
    if (u.startsWith("/api/transcribe")) {
      gate = w2eGate();
    }
    return gate.then(() => {
      if (u.startsWith("/api")) {
        opts.headers = { ...(opts.headers || {}),
                         "x-session-key": sessionKey() };
      }
      return _fetch(url, opts);
    });
  }
  const token = localStorage.getItem(TOKEN_KEY);
  if (token && u.startsWith("/api")) {
    opts.headers = { ...(opts.headers || {}),
                     Authorization: `Bearer ${token}` };
  }
  return _fetch(url, opts).then((resp) => {
    if (resp.status === 401 && u.startsWith("/api") &&
        !u.includes("/api/auth/")) {
      showAuth();
    }
    return resp;
  });
};

let registerMode = false;

function showAuth() {
  $("#auth-overlay").hidden = false;
}

function setAuthMode(reg) {
  registerMode = reg;
  $("#auth-title").textContent = reg ? "Create account" : "Sign in";
  $("#auth-submit").textContent = reg ? "Register" : "Sign in";
  $("#auth-code").hidden = !reg;
  $("#auth-toggle").textContent = reg
    ? "Have an account? Sign in" : "Need an account? Register";
}

document.addEventListener("DOMContentLoaded", () => {
  if (WAV2ELAN) {
    // wav2elan gate wiring (reference :157-178): Enter or the button
    // validates; wrong password shows the inline error and refocuses.
    const validate = () => {
      if ($("#password-input").value === W2E_PASSWORD) {
        sessionStorage.setItem("authenticated", "true");
        $("#password-modal").hidden = true;
        $("#password-error").hidden = true;
        const resolve = w2eGateResolve;
        w2eGateResolve = null;
        if (resolve) resolve();
      } else {
        $("#password-error").hidden = false;
        $("#password-input").value = "";
        $("#password-input").focus();
      }
    };
    $("#password-submit").onclick = validate;
    $("#password-input").onkeydown = (e) => {
      if (e.key === "Enter") {
        e.preventDefault();
        validate();
      }
    };
    $("#password-cancel").onclick = () => {
      $("#password-modal").hidden = true;
      w2eGateResolve = null;   // abandoned upload stays pending-free
    };
  }
  $("#auth-toggle").onclick = (e) => {
    e.preventDefault();
    setAuthMode(!registerMode);
  };
  $("#auth-form").onsubmit = async (e) => {
    e.preventDefault();
    const body = {
      email: $("#auth-email").value.trim(),
      password: $("#auth-password").value,
    };
    if (registerMode) body.access_code = $("#auth-code").value.trim();
    const url = registerMode ? "/api/auth/register" : "/api/auth/login";
    const resp = await _fetch(url, {
      method: "POST",
      headers: { "Content-Type": "application/json" },
      body: JSON.stringify(body),
    });
    const out = await resp.json();
    if (resp.ok && out.token) {
      localStorage.setItem(TOKEN_KEY, out.token);
      $("#auth-overlay").hidden = true;
      refreshHistory();
    } else {
      $("#auth-error").textContent = out.error || "Failed.";
    }
  };
});

// ------------------------------------------------------------- dialogs
// Promise-based modal replacing prompt() (the reference uses real UI too).

function showDialog(title, fields) {
  return new Promise((resolve) => {
    $("#dialog-title").textContent = title;
    const body = $("#dialog-body");
    body.innerHTML = "";
    const inputs = {};
    for (const f of fields) {
      const label = document.createElement("label");
      label.textContent = f.label;
      let input;
      if (f.options) {
        input = document.createElement("select");
        for (const o of f.options) {
          const opt = document.createElement("option");
          opt.value = o;
          opt.textContent = o;
          if (o === f.value) opt.selected = true;
          input.appendChild(opt);
        }
      } else {
        input = document.createElement("input");
        input.value = f.value ?? "";
        if (f.type) input.type = f.type;
        if (f.step) input.step = f.step;
      }
      inputs[f.name] = input;
      label.appendChild(input);
      body.appendChild(label);
    }
    $("#dialog-overlay").hidden = false;
    const first = Object.values(inputs)[0];
    if (first) first.focus();
    const done = (vals) => {
      $("#dialog-overlay").hidden = true;
      $("#dialog-form").onsubmit = null;
      $("#dialog-cancel").onclick = null;
      resolve(vals);
    };
    $("#dialog-form").onsubmit = (e) => {
      e.preventDefault();
      const vals = {};
      for (const [k, el] of Object.entries(inputs)) vals[k] = el.value;
      done(vals);
    };
    $("#dialog-cancel").onclick = () => done(null);
  });
}

// Okabe-Ito colorblind-safe palette for speaker/language coloring.
const PALETTE = ["#0072B2", "#E69F00", "#009E73", "#CC79A7",
                 "#56B4E9", "#D55E00", "#F0E442", "#999999"];

let activeId = null;
let activeData = null;
let wordEls = [];
let segEls = [];

// ---------------------------------------------------------------- undo
// Undo/redo stacks over segment-list snapshots (reference app.js:2060-2178).

const undoStack = [];
const redoStack = [];
const UNDO_MAX = 50;

function pushUndo() {
  if (!activeData) return;
  undoStack.push(JSON.stringify(activeData.segments || []));
  if (undoStack.length > UNDO_MAX) undoStack.shift();
  redoStack.length = 0;
}

async function undo() {
  if (!undoStack.length || !activeData) return;
  redoStack.push(JSON.stringify(activeData.segments || []));
  activeData.segments = JSON.parse(undoStack.pop());
  await saveSegments();
  render();
}

async function redo() {
  if (!redoStack.length || !activeData) return;
  undoStack.push(JSON.stringify(activeData.segments || []));
  activeData.segments = JSON.parse(redoStack.pop());
  await saveSegments();
  render();
}

// ---------------------------------------------------------------- history

// blob-URL audio cache so uploads play back immediately, before the server
// round-trip (reference app.js:114-116, 2260-2276)
const blobUrls = {};   // file_name -> object URL
const placeholders = [];  // file names currently transcribing

async function refreshHistory() {
  const items = await (await fetch("/api/history")).json();
  const ul = $("#history");
  ul.innerHTML = "";
  for (const name of placeholders) {
    const li = document.createElement("li");
    li.className = "placeholder";
    li.innerHTML = `<span class="spin"></span>${name}`;
    ul.appendChild(li);
  }
  for (const item of items) {
    const li = document.createElement("li");
    li.textContent = item.file_name;
    li.title = item.created_at;
    li.className = item.id === activeId ? "active" : "";
    li.onclick = () => openEntry(item.id);
    const del = document.createElement("button");
    del.textContent = "×";
    del.className = "del";
    del.onclick = async (e) => {
      e.stopPropagation();
      await fetch(`/api/history/${item.id}`, { method: "DELETE" });
      if (item.id === activeId) { activeId = null; showEmpty(); }
      refreshHistory();
    };
    li.appendChild(del);
    ul.appendChild(li);
  }
  // demo entry pinned at the bottom (reference prepends DEMO_EXAMPLE)
  const demoLi = document.createElement("li");
  demoLi.className = "demo" + (activeId === "demo" ? " active" : "");
  demoLi.textContent = "✨ Demo: code-switching";
  demoLi.onclick = openDemo;
  ul.appendChild(demoLi);
}

async function openDemo() {
  try {
    const demo = await (await fetch("/api/demo")).json();
    if (demo && demo.segments) {
      activeId = "demo";
      activeData = demo;
      resetViewer();
      render();
      refreshHistory();
    }
  } catch { /* demo optional */ }
}

async function openEntry(id) {
  const resp = await fetch(`/api/history/${id}`);
  if (!resp.ok) return;
  activeId = id;
  activeData = await resp.json();
  if (!activeData.audio_url && blobUrls[activeData.file_name]) {
    activeData.audio_url = blobUrls[activeData.file_name];
  }
  resetViewer();
  render();
  refreshHistory();
}

function resetViewer() {
  undoStack.length = 0;
  redoStack.length = 0;
  decodedAudio = null;
  view = { start: 0, dur: 0 };
  selection = null;
  specRegion = null;
  $("#snippet-btn").hidden = true;
}

// ---------------------------------------------------------------- upload

function setProgress(text, frac) {
  $("#progress").hidden = false;
  $("#progress-label").textContent = text;
  $("#progress-fill").style.width = `${Math.round(frac * 100)}%`;
  if (frac >= 1) setTimeout(() => { $("#progress").hidden = true; }, 800);
}

async function uploadFiles(files) {
  const form = new FormData();
  const batch = files.length > 1 ||
    files[0].name.toLowerCase().endsWith(".zip");
  for (const f of files) {
    form.append(batch ? "files" : "file", f);
    if (!f.name.toLowerCase().endsWith(".zip")) {
      blobUrls[f.name] = URL.createObjectURL(f);  // local playback cache
    }
    placeholders.push(f.name);
  }
  refreshHistory();
  const lang = $("#opt-language").value.trim();
  const spk = $("#opt-speakers").value.trim();
  const orth = $("#opt-orthography").value;
  if (lang) form.append("language", lang);
  if (spk) form.append("speaker_count", spk);
  if (orth) form.append("orthography", orth);
  // single files use the live route (incremental 'segments' events);
  // batches use the reference batch SSE route
  const endpoint = batch ? "/api/transcribe-batch-stream"
                         : "/api/transcribe-stream-live";
  let resp = await fetch(endpoint, { method: "POST", body: form });
  if (resp.status === 501 && !batch) {
    resp = await fetch("/api/transcribe-stream", { method: "POST", body: form });
  }
  if (!resp.ok) {
    setProgress("Upload failed", 1);
    placeholders.length = 0;
    refreshHistory();
    return;
  }
  let liveSegments = [];

  // Manual SSE reader, split-frame safe.
  const reader = resp.body.getReader();
  const decoder = new TextDecoder();
  let buf = "";
  let lastEntry = null;
  for (;;) {
    const { done, value } = await reader.read();
    if (done) break;
    buf += decoder.decode(value, { stream: true });
    let idx;
    while ((idx = buf.indexOf("\n\n")) >= 0) {
      const frame = buf.slice(0, idx);
      buf = buf.slice(idx + 2);
      let event = "", data = "";
      for (const line of frame.split("\n")) {
        if (line.startsWith("event: ")) event = line.slice(7);
        else if (line.startsWith("data: ")) data += line.slice(6);
      }
      if (!event) continue;
      const payload = JSON.parse(data);
      if (event === "progress") {
        const steps = ["uploading", "transcribing", "processing", "done"];
        const i = steps.indexOf(payload.step);
        const prefix = payload.file_count
          ? `[${(payload.file_index ?? 0) + 1}/${payload.file_count}] ` : "";
        // intra-step fraction from per-batch device progress
        let frac = (i + 1) / steps.length;
        if (payload.fraction != null && i >= 0) {
          frac = (i + payload.fraction) / steps.length;
        }
        setProgress(`${prefix}${payload.file_name}: ${payload.step}`, frac);
      } else if (event === "segments") {
        // incremental transcript: render as batches finish
        liveSegments = liveSegments.concat(payload.segments);
        activeId = null;
        activeData = { file_name: files[0].name, segments: liveSegments,
                       audio_url: blobUrls[files[0].name] };
        render();
      } else if (event === "result") {
        lastEntry = payload.results ? payload.results[0] : payload;
      } else if (event === "error") {
        setProgress(`Error: ${payload.error}`, 1);
      }
    }
  }
  placeholders.length = 0;
  await refreshHistory();
  if (lastEntry && lastEntry.id) openEntry(lastEntry.id);
}

// ---------------------------------------------------------------- render

function showEmpty() {
  $("#viewer").hidden = true;
  $("#empty-state").hidden = false;
}

function colorFor(key, map) {
  if (!(key in map)) map[key] = PALETTE[Object.keys(map).length % PALETTE.length];
  return map[key];
}

function fmtTime(s) {
  const m = Math.floor(s / 60);
  return `${m}:${String(Math.floor(s % 60)).padStart(2, "0")}`;
}

function render() {
  $("#empty-state").hidden = true;
  $("#viewer").hidden = false;
  $("#file-name").textContent = activeData.file_name || "transcript";
  $("#summary").textContent = activeData.summary || "";

  const badges = $("#badges");
  badges.innerHTML = "";
  const speakers = [...new Set((activeData.segments || []).map(s => s.speaker))];
  const langs = activeData.detected_languages || [];
  const emotions = [...new Set((activeData.segments || [])
    .map(s => s.emotion).filter(Boolean))];
  for (const sp of speakers) addBadge(badges, sp, "spk");
  for (const l of langs) addBadge(badges, `${l.language} (${l.code})`, "lang");
  for (const e of emotions) addBadge(badges, e, "emo");

  const audio = $("#audio");
  if (activeData.audio_url) {
    if (audio.src !== new URL(activeData.audio_url, location).href) {
      audio.src = activeData.audio_url;
    }
    audio.hidden = false;
  } else {
    audio.hidden = true;
  }

  renderTranscript();
  redrawViz();
}

function addBadge(parent, text, cls) {
  const b = document.createElement("span");
  b.className = `badge ${cls}`;
  b.textContent = text;
  parent.appendChild(b);
}

function highlightKey(seg) {
  const mode = $("#highlight-mode").value;
  if (mode === "speaker") return seg.speaker;
  if (mode === "language") return seg.language_code || seg.language || "?";
  if (mode === "emotion") return seg.emotion || "neutral";
  // chunk mode: color by 300 s chunk index (reference highlight mode)
  if (mode === "chunk") return `chunk${Math.floor(seg.start / 300)}`;
  return null;
}

// Code-switching color: average the colors of all languages in the segment
// (the reference's averaging approach for multi-language segments).
function mixColors(hexes) {
  let r = 0, g = 0, b = 0;
  for (const h of hexes) {
    r += parseInt(h.slice(1, 3), 16);
    g += parseInt(h.slice(3, 5), 16);
    b += parseInt(h.slice(5, 7), 16);
  }
  const n = hexes.length || 1;
  const c = (v) => Math.round(v / n).toString(16).padStart(2, "0");
  return `#${c(r)}${c(g)}${c(b)}`;
}

function segmentColor(seg, colorMap) {
  const mode = $("#highlight-mode").value;
  if (mode === "language" && seg.languages && seg.languages.length > 1) {
    return mixColors(seg.languages.map((l) => colorFor(l.code, colorMap)));
  }
  const key = highlightKey(seg);
  return key === null ? "#3a4048" : colorFor(key, colorMap);
}

let boxView = false;

// Translation auto-show heuristic: show translations when any non-English
// language was detected (reference app.js:683-693); user toggle overrides.
let showTranslations = null;  // null = auto

function translationsVisible() {
  if (showTranslations !== null) return showTranslations;
  const langs = activeData.detected_languages || [];
  return langs.some((l) => l.code && l.code !== "en");
}

function renderTranscript() {
  const root = $("#transcript");
  root.innerHTML = "";
  wordEls = [];
  segEls = [];
  const spkColors = {};
  root.classList.toggle("box-view", boxView);
  const showTr = translationsVisible();
  (activeData.segments || []).forEach((seg, si) => {
    const div = document.createElement("div");
    div.className = "segment";
    div.style.borderLeftColor = segmentColor(seg, spkColors);
    if (boxView) div.style.background = segmentColor(seg, spkColors) + "22";
    div.oncontextmenu = (e) => {
      e.preventDefault();
      openCtxMenu(e, si);
    };
    segEls.push(div);

    const head = document.createElement("div");
    head.className = "seg-head";
    // speaker badge carries a colorblind-safe per-speaker dot (CSS
    // ::before on currentColor); emotion gets a per-class tint
    // (reference speaker-badge / emotion-indicator styling)
    head.innerHTML =
      `<span class="speaker">${seg.speaker}</span>` +
      (seg.language_code
        ? `<span class="tag lang">${seg.language_code}</span>` : "") +
      (seg.emotion && seg.emotion !== "neutral"
        ? `<span class="tag emo emo-${seg.emotion}">${seg.emotion}</span>`
        : "") +
      `<span class="time">${fmtTime(seg.start)}–${fmtTime(seg.end)}</span>`;
    head.querySelector(".speaker").style.color =
      colorFor(seg.speaker, spkColors);
    head.querySelector(".time").onclick = (e) => {
      if (e.altKey) editTimestamps(si); else seek(seg.start);
    };
    head.querySelector(".time").title = "click: seek · alt-click: edit times";
    // click speaker name -> rename across all segments (reference
    // renameSpeaker workflow)
    head.querySelector(".speaker").onclick = () => renameSpeaker(seg.speaker);
    div.appendChild(head);

    const body = document.createElement("div");
    body.className = "seg-text";
    if (seg.words && seg.words.length) {
      seg.words.forEach((w, wi) => {
        const el = document.createElement("span");
        el.className = "word";
        el.textContent = w.word + " ";
        el.dataset.start = w.start;
        el.dataset.end = w.end;
        // click a word: play exactly that word, then pause (reference
        // playWord per-word playback, app.js:1049-1051)
        el.onclick = () => playSpan(w.start, w.end);
        // word-level text editing (reference word editor)
        el.ondblclick = (e) => {
          e.stopPropagation();
          editWord(si, wi, el);
        };
        // per-word playback/edit context menu
        el.oncontextmenu = (e) => {
          e.preventDefault();
          e.stopPropagation();
          openWordCtxMenu(e, si, wi, el);
        };
        body.appendChild(el);
        wordEls.push(el);
      });
    } else {
      body.textContent = seg.text;
    }
    body.ondblclick = () => editSegment(si, body);
    div.appendChild(body);

    if (showTr && seg.translation && seg.translation !== "null") {
      const tr = document.createElement("div");
      tr.className = "translation";
      tr.textContent = seg.translation;  // "Translation:" label via CSS
      div.appendChild(tr);
    }
    root.appendChild(div);
  });
}

// inline editing -> PUT /api/history/{id} (same contract as the reference
// editor's saveActiveData)
function editSegment(si, body) {
  const seg = activeData.segments[si];
  const input = document.createElement("textarea");
  input.value = seg.text;
  input.className = "edit-box";
  body.replaceWith(input);
  input.focus();
  showIpaPicker(input);
  const save = async () => {
    pushUndo();
    seg.text = input.value;
    if (seg.words) delete seg.words;  // word alignment invalidated by edit
    await saveSegments();
    renderTranscript();
  };
  input.onblur = save;
  input.onkeydown = (e) => {
    if (e.key === "Enter" && !e.shiftKey) { e.preventDefault(); input.blur(); }
    if (e.key === "Escape") { input.onblur = null; renderTranscript(); }
  };
}

// word-level text editing: dblclick a word, edit only it; segment text is
// rebuilt from the words (reference word editor behavior)
function editWord(si, wi, el) {
  const seg = activeData.segments[si];
  const w = seg.words[wi];
  const input = document.createElement("input");
  input.value = w.word;
  input.className = "edit-box word-edit";
  input.size = Math.max(3, w.word.length + 2);
  el.replaceWith(input);
  input.focus();
  input.select();
  showIpaPicker(input);
  const save = async () => {
    pushUndo();
    const v = input.value.trim();
    if (v) {
      w.word = v;
    } else {
      seg.words.splice(wi, 1);  // emptied -> delete the word
    }
    seg.text = seg.words.map((x) => x.word).join(" ");
    await saveSegments();
    renderTranscript();
  };
  input.onblur = save;
  input.onkeydown = (e) => {
    if (e.key === "Enter") { e.preventDefault(); input.blur(); }
    if (e.key === "Escape") { input.onblur = null; renderTranscript(); }
  };
}

async function saveSegments() {
  if (!activeId || activeId === "demo") return;
  await fetch(`/api/history/${activeId}`, {
    method: "PUT",
    headers: { "Content-Type": "application/json" },
    body: JSON.stringify({ segments: activeData.segments }),
  });
}

async function renameSpeaker(oldName) {
  const vals = await showDialog("Rename speaker", [
    { name: "name", label: `Rename "${oldName}" to:`, value: oldName },
  ]);
  if (!vals || !vals.name || vals.name === oldName) return;
  pushUndo();
  for (const seg of activeData.segments) {
    if (seg.speaker === oldName) seg.speaker = vals.name;
  }
  await saveSegments();
  render();
}

// timestamp editor: click the time range with alt/option to adjust
async function editTimestamps(si) {
  const seg = activeData.segments[si];
  const vals = await showDialog("Edit timestamps", [
    { name: "start", label: "Start (s)", value: seg.start.toFixed(2),
      type: "number", step: "0.01" },
    { name: "end", label: "End (s)", value: seg.end.toFixed(2),
      type: "number", step: "0.01" },
  ]);
  if (!vals) return;
  const start = parseFloat(vals.start), end = parseFloat(vals.end);
  if (!(end > start)) return;
  pushUndo();
  seg.start = start;
  seg.end = end;
  await saveSegments();
  render();
}

// IPA character picker (reference index.html:493): inserts into the
// active inline editor
const IPA_CHARS = [
  "ɐ","ɑ","ɒ","æ","ə","ɛ","ɜ","ɪ","ɨ","ɔ","ø","ɵ","œ","ʉ","ʊ","ʌ","ː",
  "ˈ","ˌ","ʔ","ʕ","β","ç","ð","ɸ","ɣ","ɥ","ɧ","ʝ","ɫ","ɬ","ɭ","ʟ","ɱ",
  "ŋ","ɲ","ɳ","ɾ","ʀ","ʁ","ɹ","ɻ","ʃ","ʂ","θ","ʈ","ʋ","ʍ","χ","ʎ","ʒ",
  "ʐ","ʑ","ʘ","ǀ","ǁ","ǂ","ǃ","ɓ","ɗ","ɠ","ʛ","ẽ","ã","õ","ĩ","ũ","̃",
];

function showIpaPicker(target) {
  let panel = $("#ipa-panel");
  if (panel) panel.remove();
  panel = document.createElement("div");
  panel.id = "ipa-panel";
  for (const ch of IPA_CHARS) {
    const b = document.createElement("button");
    b.type = "button";
    b.textContent = ch;
    b.onmousedown = (e) => {
      e.preventDefault();  // keep the textarea focused
      const start = target.selectionStart;
      target.value = target.value.slice(0, start) + ch +
        target.value.slice(target.selectionEnd);
      target.selectionStart = target.selectionEnd = start + ch.length;
    };
    panel.appendChild(b);
  }
  document.body.appendChild(panel);
  const r = target.getBoundingClientRect();
  panel.style.left = `${r.left + window.scrollX}px`;
  panel.style.top = `${r.bottom + window.scrollY + 4}px`;
  panel.hidden = false;
  target.addEventListener("blur",
                          () => setTimeout(() => panel.remove(), 200),
                          { once: true });
}

// context menu: emotion / rename / split / merge / delete
let ctxSegIndex = null;

function openCtxMenu(e, si) {
  ctxSegIndex = si;
  const menu = $("#ctx-menu");
  menu.hidden = false;
  menu.style.left = `${e.pageX}px`;
  menu.style.top = `${e.pageY}px`;
}

document.addEventListener("click", () => {
  $("#ctx-menu").hidden = true;
  $("#word-ctx-menu").hidden = true;
});

// per-word context menu: play / loop / edit / delete (reference per-word
// playback + inline editor interactions, app.js:1049-1055, :2099)
let ctxWord = null;  // {si, wi, el}

function openWordCtxMenu(e, si, wi, el) {
  ctxWord = { si, wi, el };
  const menu = $("#word-ctx-menu");
  menu.hidden = false;
  menu.style.left = `${e.pageX}px`;
  menu.style.top = `${e.pageY}px`;
}

document.querySelectorAll("#word-ctx-menu button").forEach((btn) => {
  btn.onclick = async () => {
    $("#word-ctx-menu").hidden = true;
    if (ctxWord === null) return;
    const { si, wi, el } = ctxWord;
    ctxWord = null;
    const seg = activeData.segments[si];
    const w = seg?.words?.[wi];
    if (!w) return;
    const act = btn.dataset.act;
    if (act === "play") {
      playSpan(w.start, w.end);
    } else if (act === "loop") {
      // bounded loop over just this word (selection + loop toggle)
      selection = { start: w.start, end: w.end };
      loopOn = true;
      $("#loop-toggle").classList.toggle("on", true);
      drawOverlay();
      playSpan(w.start, w.end);
      stopSpanAt = null;  // the loop owns the span; no one-shot stop
    } else if (act === "edit") {
      editWord(si, wi, el);
    } else if (act === "delete") {
      pushUndo();
      seg.words.splice(wi, 1);
      seg.text = seg.words.map((x) => x.word).join(" ");
      await saveSegments();
      renderTranscript();
    }
  };
});
document.querySelectorAll("#ctx-menu button").forEach((btn) => {
  btn.onclick = async () => {
    $("#ctx-menu").hidden = true;
    if (ctxSegIndex === null) return;
    const seg = activeData.segments[ctxSegIndex];
    const act = btn.dataset.act;
    if (act === "rename") {
      await renameSpeaker(seg.speaker);
      return;
    }
    if (act === "emotion") {
      const vals = await showDialog("Set emotion", [
        { name: "emotion", label: "Emotion", value: seg.emotion || "neutral",
          options: ["happy", "sad", "angry", "neutral"] },
      ]);
      if (!vals) return;
      pushUndo();
      seg.emotion = vals.emotion;
    } else if (act === "split") {
      const t = $("#audio").currentTime;
      if (!(t > seg.start && t < seg.end)) return;
      pushUndo();
      const left = { ...seg, end: t };
      const right = { ...seg, start: t };
      if (seg.words) {
        left.words = seg.words.filter((w) => w.start < t);
        right.words = seg.words.filter((w) => w.start >= t);
        left.text = left.words.map((w) => w.word).join(" ") || seg.text;
        right.text = right.words.map((w) => w.word).join(" ") || seg.text;
      }
      activeData.segments.splice(ctxSegIndex, 1, left, right);
    } else if (act === "merge") {
      const nxt = activeData.segments[ctxSegIndex + 1];
      if (!nxt) return;
      pushUndo();
      seg.end = nxt.end;
      seg.text = `${seg.text} ${nxt.text}`.trim();
      if (seg.words && nxt.words) seg.words = seg.words.concat(nxt.words);
      else delete seg.words;
      activeData.segments.splice(ctxSegIndex + 1, 1);
    } else if (act === "delete") {
      pushUndo();
      activeData.segments.splice(ctxSegIndex, 1);
    }
    await saveSegments();
    render();
  };
});

$("#highlight-mode").onchange = () => renderTranscript();
$("#view-toggle").onclick = () => {
  boxView = !boxView;
  $("#view-toggle").textContent = boxView ? "Flow view" : "Box view";
  renderTranscript();
};

// ---------------------------------------------------------------- playback

function seek(t) {
  const audio = $("#audio");
  stopSpanAt = null;
  if (!audio.hidden) { audio.currentTime = t; audio.play(); }
}

// Bounded playback of one word/segment span: start there, auto-pause at the
// end (reference playWord :2099 semantics). Any other seek cancels the stop.
let stopSpanAt = null;
function playSpan(start, end) {
  if (!(end > start)) return;
  const audio = $("#audio");
  if (audio.hidden) return;
  audio.currentTime = start;
  stopSpanAt = end;
  audio.play();
}
$("#audio").addEventListener("timeupdate", () => {
  const audio = $("#audio");
  if (stopSpanAt !== null && audio.currentTime >= stopSpanAt) {
    audio.pause();
    stopSpanAt = null;
  }
});

let loopOn = false;

$("#skip-back").onclick = () => { $("#audio").currentTime -= 10; };
$("#skip-fwd").onclick = () => { $("#audio").currentTime += 10; };

// segment navigation (reference navigateSegment :4155)
function navigateSegment(dir) {
  const segs = activeData?.segments || [];
  if (!segs.length) return;
  const t = $("#audio").currentTime;
  let idx = segs.findIndex((s) => t >= s.start && t < s.end);
  if (idx >= 0) {
    idx += dir;
  } else {
    // In a gap (or past the end): next -> following segment, prev -> the
    // segment before the gap (findIndex yields -1 after the last segment).
    let next = segs.findIndex((s) => s.start > t);
    if (next < 0) next = segs.length;
    idx = dir > 0 ? next : next - 1;
  }
  idx = Math.min(segs.length - 1, Math.max(0, idx));
  seek(segs[idx].start);
  segEls[idx]?.scrollIntoView({ block: "nearest", behavior: "smooth" });
}

$("#seg-prev").onclick = () => navigateSegment(-1);
$("#seg-next").onclick = () => navigateSegment(1);
$("#loop-toggle").onclick = toggleLoop;

function toggleLoop() {
  loopOn = !loopOn;
  $("#loop-toggle").textContent = loopOn ? "Loop: on" : "Loop: off";
  $("#loop-toggle").classList.toggle("on", loopOn);
}

setInterval(() => {
  const audio = $("#audio");
  if (audio.hidden) return;
  // loop selection (reference toggleLoop :4677)
  if (loopOn && selection && !audio.paused) {
    if (audio.currentTime >= selection.end || audio.currentTime < selection.start - 0.05) {
      audio.currentTime = selection.start;
    }
  }
  drawOverlay();
  if (audio.paused) return;
  const t = audio.currentTime;
  for (const el of wordEls) {
    const on = t >= +el.dataset.start && t < +el.dataset.end;
    el.classList.toggle("playing", on);
  }
  // active-segment emphasis during playback (reference .segment.selected)
  const segs = activeData?.segments || [];
  segEls.forEach((el, i) => {
    const s = segs[i];
    el.classList.toggle("active", Boolean(s) && t >= s.start && t < s.end);
  });
}, 80);

// ------------------------------------------------------------ audio decode
// One decode per entry, shared by waveform/spectrogram/drag editor.

let decodedAudio = null;   // {data: Float32Array, sr, duration}
let decodePending = null;

async function ensureDecoded() {
  if (decodedAudio) return decodedAudio;
  if (!activeData?.audio_url) return null;
  if (decodePending) return decodePending;
  decodePending = (async () => {
    try {
      const buf = await (await fetch(activeData.audio_url)).arrayBuffer();
      const actx = new (window.AudioContext || window.webkitAudioContext)();
      const dec = await actx.decodeAudioData(buf);
      actx.close();
      decodedAudio = {
        data: dec.getChannelData(0),
        sr: dec.sampleRate,
        duration: dec.duration,
      };
      if (!view.dur) view = { start: 0, dur: decodedAudio.duration };
      return decodedAudio;
    } catch {
      return null;
    } finally {
      decodePending = null;
    }
  })();
  return decodePending;
}

// ------------------------------------------------------- viewport & zoom

let view = { start: 0, dur: 0 };   // visible window in seconds
let selection = null;              // {start, end} seconds or null

function clampView() {
  if (!decodedAudio) return;
  const D = decodedAudio.duration;
  view.dur = Math.min(Math.max(view.dur, 0.05), D);
  view.start = Math.min(Math.max(view.start, 0), Math.max(0, D - view.dur));
}

function setZoom(factor, centerT) {
  if (!decodedAudio) return;
  const D = decodedAudio.duration;
  const c = centerT ?? (view.start + view.dur / 2);
  view.dur = Math.min(D, view.dur / factor);
  view.start = c - view.dur / 2;
  clampView();
  $("#zoom-label").textContent = `${(D / view.dur).toFixed(D / view.dur < 10 ? 1 : 0)}×`;
  redrawViz();
}

$("#zoom-in").onclick = () => setZoom(2);
$("#zoom-out").onclick = () => setZoom(0.5);
$("#zoom-fit").onclick = () => {
  if (!decodedAudio) return;
  view = { start: 0, dur: decodedAudio.duration };
  $("#zoom-label").textContent = "1×";
  redrawViz();
};

function xToTime(x, canvas) {
  return view.start + (x / canvas.clientWidth) * view.dur;
}

function timeToX(t, canvas) {
  return ((t - view.start) / view.dur) * canvas.clientWidth;
}

function redrawViz() {
  if ($("#spectrogram").hidden) drawWaveform();
  else drawSpectrogram();
  drawOverlay();
}

// ---------------------------------------------------------------- waveform

async function drawWaveform() {
  const canvas = $("#waveform");
  const ctx = canvas.getContext("2d");
  canvas.width = canvas.clientWidth * devicePixelRatio;
  ctx.clearRect(0, 0, canvas.width, canvas.height);
  const dec = await ensureDecoded();
  if (!dec) return;
  clampView();
  const { data, sr } = dec;
  const W = canvas.width, H = canvas.height;
  const s0 = Math.floor(view.start * sr);
  const span = Math.floor(view.dur * sr);
  const per = Math.max(1, span / W);
  ctx.fillStyle = "#4a90d9";
  for (let x = 0; x < W; x++) {
    let lo = 0, hi = 0;
    const a = s0 + Math.floor(x * per);
    const b = Math.min(s0 + Math.floor((x + 1) * per) + 1, data.length);
    for (let i = a; i < b; i++) {
      if (data[i] < lo) lo = data[i];
      if (data[i] > hi) hi = data[i];
    }
    const mid = H / 2;
    ctx.fillRect(x, mid + lo * mid, 1, Math.max(1, (hi - lo) * mid));
  }
}

// ------------------------------------------------------------- spectrogram
// Praat-style display: pre-emphasis 6 dB/oct, Hann window, mel-scale
// frequency axis, auto max-frequency detection, 70 dB dynamic range.
// Layered viewport cache (reference app.js:2888-3139): the spectrogram +
// formant + intensity layers are rendered ONCE into an offscreen canvas
// covering the visible window plus a buffer on each side; pans and zooms
// inside the cached region are a single drawImage blit, and the region is
// recomputed only when the view scrolls/zooms out of it.

let specRegion = null;  // {canvas, url, t0, t1, colsPerSec, H, maxHz}
const maxFreqCache = new Map();  // audio_url -> detected max frequency (Hz)

function hzToMel(f) { return 2595 * Math.log10(1 + f / 700); }
function melToHz(m) { return 700 * (Math.pow(10, m / 2595) - 1); }

function fftRadix2(re, im) {
  // iterative in-place Cooley-Tukey
  const n = re.length;
  for (let i = 1, j = 0; i < n; i++) {
    let bit = n >> 1;
    for (; j & bit; bit >>= 1) j ^= bit;
    j ^= bit;
    if (i < j) {
      [re[i], re[j]] = [re[j], re[i]];
      [im[i], im[j]] = [im[j], im[i]];
    }
  }
  for (let len = 2; len <= n; len <<= 1) {
    const ang = -2 * Math.PI / len;
    const wr = Math.cos(ang), wi = Math.sin(ang);
    for (let i = 0; i < n; i += len) {
      let cr = 1, ci = 0;
      for (let k = 0; k < len / 2; k++) {
        const ur = re[i + k], ui = im[i + k];
        const vr = re[i + k + len / 2] * cr - im[i + k + len / 2] * ci;
        const vi = re[i + k + len / 2] * ci + im[i + k + len / 2] * cr;
        re[i + k] = ur + vr; im[i + k] = ui + vi;
        re[i + k + len / 2] = ur - vr; im[i + k + len / 2] = ui - vi;
        const ncr = cr * wr - ci * wi;
        ci = cr * wi + ci * wr; cr = ncr;
      }
    }
  }
}

function heatColor(v) {
  // 0..1 -> dark blue -> cyan -> yellow
  const r = Math.min(255, Math.max(0, Math.round(510 * (v - 0.5))));
  const g = Math.min(255, Math.max(0, Math.round(v < 0.5 ? 510 * v : 255)));
  const b = Math.min(255, Math.max(0, Math.round(v < 0.5 ? 100 + 310 * v : 255 * (1.5 - v))));
  return [r, g, b];
}

// auto max-frequency: spectral rolloff over sampled columns — the highest
// frequency holding meaningful energy (reference auto max-freq detection)
function autoMaxFreq(data, sr) {
  const NFFT = 1024;
  const step = Math.max(NFFT, Math.floor(data.length / 40));
  const acc = new Float64Array(NFFT / 2);
  for (let off = 0; off + NFFT < data.length; off += step) {
    const re = new Float32Array(NFFT), im = new Float32Array(NFFT);
    for (let i = 0; i < NFFT; i++) re[i] = data[off + i];
    fftRadix2(re, im);
    for (let b = 0; b < NFFT / 2; b++) acc[b] += re[b] * re[b] + im[b] * im[b];
  }
  let total = 0;
  for (let b = 0; b < NFFT / 2; b++) total += acc[b];
  let cum = 0;
  for (let b = 0; b < NFFT / 2; b++) {
    cum += acc[b];
    if (cum >= 0.99 * total) {
      const f = (b / (NFFT / 2)) * (sr / 2);
      return Math.min(sr / 2, Math.max(3000, Math.ceil(f / 500) * 500));
    }
  }
  return sr / 2;
}

// Render one cached region [t0, t1] at colsPerSec columns/second into an
// offscreen canvas: spectrogram image + formant dots + intensity curve,
// all time-aligned so a blit of any sub-range stays coordinate-exact.
function buildSpecRegion(data, sr, url, t0, t1, colsPerSec, H, maxHz) {
  const melMax = hzToMel(maxHz);
  const NFFT = 1024;
  const hop = Math.max(1, Math.round(sr / colsPerSec));
  const cols = Math.max(1, Math.round((t1 - t0) * sr / hop));
  const s0 = Math.floor(t0 * sr);
  const offc = document.createElement("canvas");
  offc.width = cols; offc.height = H;
  const ctx = offc.getContext("2d");
  const win = new Float32Array(NFFT);
  for (let i = 0; i < NFFT; i++) {
    win[i] = 0.5 - 0.5 * Math.cos(2 * Math.PI * i / NFFT);
  }
  const img = ctx.createImageData(cols, H);
  const DYN = 70; // dB dynamic range (Praat default)
  // mel row -> FFT bin lookup
  const binOf = new Int32Array(H);
  for (let y = 0; y < H; y++) {
    const mel = (1 - y / H) * melMax;
    const hz = melToHz(mel);
    binOf[y] = Math.min(NFFT / 2 - 1, Math.round((hz / (sr / 2)) * (NFFT / 2)));
  }
  const colDb = new Float32Array(cols);  // per-column RMS for intensity
  for (let x = 0; x < cols; x++) {
    const re = new Float32Array(NFFT), im = new Float32Array(NFFT);
    const off = s0 + x * hop;
    let energy = 0;
    for (let i = 0; i < NFFT; i++) {
      // pre-emphasis +6 dB/oct (Praat default)
      const s = (data[off + i] || 0) - 0.97 * (data[off + i - 1] || 0);
      re[i] = s * win[i];
      energy += re[i] * re[i];
    }
    colDb[x] = 10 * Math.log10(energy / NFFT + 1e-12);
    fftRadix2(re, im);
    for (let y = 0; y < H; y++) {
      const bin = binOf[y];
      const p = re[bin] * re[bin] + im[bin] * im[bin];
      const db = 10 * Math.log10(p + 1e-12);
      const v = Math.min(1, Math.max(0, (db + DYN) / DYN));
      const [r, g, b] = heatColor(v);
      const idx = (y * cols + x) * 4;
      img.data[idx] = r; img.data[idx + 1] = g; img.data[idx + 2] = b;
      img.data[idx + 3] = 255;
    }
  }
  ctx.putImageData(img, 0, 0);

  // Formant overlay (F1-F4): smoothed-spectrum peak picking per column
  // in 200-4500 Hz, Okabe-Ito colors, drawn on the mel axis (the
  // reference's viewer tracks four formants — public/static/app.js).
  const binHz = sr / NFFT;
  const loBin = Math.max(1, Math.floor(200 / binHz));
  const hiBin = Math.min(NFFT / 2 - 2, Math.ceil(Math.min(4500, maxHz) / binHz));
  const F_COLORS = ["#E69F00", "#56B4E9", "#009E73", "#CC79A7"];
  for (let x = 0; x < cols; x += 2) {
    const re = new Float32Array(NFFT), im = new Float32Array(NFFT);
    const off = s0 + x * hop;
    let energy = 0;
    for (let i = 0; i < NFFT; i++) {
      re[i] = (data[off + i] || 0) * win[i];
      energy += re[i] * re[i];
    }
    if (energy < 1e-4) continue; // silence: no formants
    fftRadix2(re, im);
    const mag = new Float32Array(hiBin + 2);
    let magMax = 0;
    for (let b_ = loBin - 1; b_ <= hiBin + 1; b_++) {
      mag[b_] = Math.sqrt(re[b_] * re[b_] + im[b_] * im[b_]);
      if (mag[b_] > magMax) magMax = mag[b_];
    }
    const peaks = [];
    for (let b_ = loBin + 2; b_ <= hiBin - 2 && peaks.length < 4; b_++) {
      const sm = (bb) => (mag[bb - 1] + mag[bb] + mag[bb + 1]) / 3;
      if (sm(b_) > sm(b_ - 1) && sm(b_) > sm(b_ + 1) &&
          sm(b_) > 0.05 * magMax) {
        peaks.push(b_);
        b_ += 2; // skip adjacent bins of the same peak
      }
    }
    peaks.forEach((bin, fi) => {
      const hz = bin * binHz;
      const y = Math.round((1 - hzToMel(hz) / melMax) * H);
      ctx.fillStyle = F_COLORS[fi];
      ctx.fillRect(x, y, 2, 2);
    });
  }

  // Intensity curve: per-column RMS in dB drawn over the spectrogram.
  ctx.strokeStyle = "rgba(255,255,255,0.85)";
  ctx.lineWidth = 1.5;
  ctx.beginPath();
  let started = false;
  for (let x = 0; x < cols; x++) {
    const v = Math.min(1, Math.max(0, (colDb[x] + DYN) / DYN));
    const y = H - 4 - v * (H - 8);
    if (started) ctx.lineTo(x, y); else { ctx.moveTo(x, y); started = true; }
  }
  ctx.stroke();

  return { canvas: offc, url, t0, t1: t0 + cols * hop / sr,
           colsPerSec: sr / hop, H, maxHz };
}

async function drawSpectrogram() {
  const canvas = $("#spectrogram");
  const ctx = canvas.getContext("2d");
  canvas.width = canvas.clientWidth * devicePixelRatio;
  const dec = await ensureDecoded();
  if (!dec) return;
  clampView();
  const { data, sr } = dec;
  const W = canvas.width, H = canvas.height;
  const url = activeData.audio_url;
  if (!maxFreqCache.has(url)) maxFreqCache.set(url, autoMaxFreq(data, sr));
  const maxHz = maxFreqCache.get(url);

  // Needed render density (columns/second); hop floor 5 ms as before.
  const needed = Math.min(200, W / view.dur);
  const r = specRegion;
  const inside = r && r.url === url && r.H === H && r.maxHz === maxHz &&
    view.start >= r.t0 - 1e-6 &&
    view.start + view.dur <= r.t1 + 1e-6;
  if (!(inside && needed <= r.colsPerSec * 1.02 &&
        needed >= r.colsPerSec / 4)) {
    // View left the cached region, or zoom changed the density by >4x:
    // recompute around the current view with a buffer on each side,
    // capped so a rebuild stays interactive (<= ~4k FFT columns).
    const D = data.length / sr;
    let buf = Math.min(10, 2 * view.dur);
    const maxCols = 4096;
    if ((view.dur + 2 * buf) * needed > maxCols) {
      buf = Math.max(0, (maxCols / needed - view.dur) / 2);
    }
    const t0 = Math.max(0, view.start - buf);
    const t1 = Math.min(D, view.start + view.dur + buf);
    specRegion = buildSpecRegion(data, sr, url, t0, t1, needed, H, maxHz);
  }
  const reg = specRegion;
  const srcX = (view.start - reg.t0) * reg.colsPerSec;
  const srcW = Math.max(1, view.dur * reg.colsPerSec);
  ctx.imageSmoothingEnabled = srcW > W;  // smooth only when minifying
  ctx.drawImage(reg.canvas, srcX, 0, srcW, H, 0, 0, W, H);

  // mel-frequency axis labels (view-independent y: stamped on the edge
  // of the visible canvas, outside the blitted region)
  const melMax = hzToMel(maxHz);
  ctx.fillStyle = "rgba(255,255,255,0.8)";
  ctx.font = "10px sans-serif";
  for (const hz of [500, 1000, 2000, 4000, 8000]) {
    if (hz > maxHz) break;
    const y = Math.round((1 - hzToMel(hz) / melMax) * H);
    ctx.fillText(hz >= 1000 ? `${hz / 1000}k` : `${hz}`, 3, y - 2);
    ctx.fillRect(0, y, 14, 1);
  }
}

let showSpectrogram = false;

$("#viz-toggle").onclick = () => {
  showSpectrogram = !showSpectrogram;
  $("#viz-toggle").textContent = showSpectrogram ? "Waveform" : "Spectrogram";
  $("#waveform").hidden = showSpectrogram;
  $("#spectrogram").hidden = !showSpectrogram;
  syncOverlaySize();
  redrawViz();
};

// ------------------------------------------------- overlay: cursor, bounds
// A transparent canvas over the waveform/spectrogram draws the playhead,
// selection, segment boundaries and drag handles; all interaction happens
// here (reference setupDragHandle :3342-3602, word drag :4448-4627,
// zoom/selection :3756-3830).

function syncOverlaySize() {
  const base = $("#spectrogram").hidden ? $("#waveform") : $("#spectrogram");
  const ov = $("#overlay");
  ov.style.height = `${base.clientHeight}px`;
  ov.height = base.height;
}

function visibleBoundaries() {
  // [{t, kind: 'seg-start'|'seg-end'|'word', si, wi}]
  const out = [];
  const segs = activeData?.segments || [];
  segs.forEach((s, si) => {
    out.push({ t: s.start, kind: "seg-start", si });
    out.push({ t: s.end, kind: "seg-end", si });
    // word boundaries only when zoomed in enough to grab them
    if (view.dur <= 12 && s.words) {
      s.words.forEach((w, wi) => {
        out.push({ t: w.start, kind: "word", si, wi });
      });
    }
  });
  return out.filter((b) => b.t >= view.start && b.t <= view.start + view.dur);
}

function drawOverlay() {
  const ov = $("#overlay");
  if (!activeData) return;
  const ctx = ov.getContext("2d");
  ov.width = ov.clientWidth * devicePixelRatio;
  ctx.clearRect(0, 0, ov.width, ov.height);
  const W = ov.width, H = ov.height;
  const dpr = devicePixelRatio;
  if (!view.dur) return;

  // selection
  if (selection) {
    const x0 = timeToX(selection.start, ov) * dpr;
    const x1 = timeToX(selection.end, ov) * dpr;
    ctx.fillStyle = "rgba(230,159,0,0.25)";
    ctx.fillRect(x0, 0, x1 - x0, H);
    ctx.fillStyle = "#E69F00";
    ctx.fillRect(x0, 0, 1.5, H);
    ctx.fillRect(x1, 0, 1.5, H);
  }

  // segment / word boundaries (edit mode)
  if ($("#edit-mode").checked) {
    for (const b of visibleBoundaries()) {
      const x = timeToX(b.t, ov) * dpr;
      if (b.kind === "word") {
        ctx.fillStyle = "rgba(86,180,233,0.7)";
        ctx.fillRect(x, H * 0.6, 1, H * 0.4);
        ctx.fillRect(x - 2 * dpr, H - 6 * dpr, 5 * dpr, 5 * dpr);
      } else {
        ctx.fillStyle = b.kind === "seg-start"
          ? "rgba(0,158,115,0.9)" : "rgba(213,94,0,0.9)";
        ctx.fillRect(x, 0, 1.5, H);
        ctx.fillRect(x - 3 * dpr, 0, 7 * dpr, 7 * dpr);
      }
    }
  }

  // playhead
  const audio = $("#audio");
  if (!audio.hidden) {
    const t = audio.currentTime;
    if (t >= view.start && t <= view.start + view.dur) {
      ctx.fillStyle = "#ffffff";
      ctx.fillRect(timeToX(t, ov) * dpr, 0, 1.5, H);
    }
  }
}

// interaction state machine on the overlay
let dragState = null;  // {mode:'select'|'boundary', ...}

function hitBoundary(x, ov) {
  if (!$("#edit-mode").checked) return null;
  const tol = 6 * (view.dur / ov.clientWidth);  // 6 px in seconds
  let best = null, bestD = tol;
  for (const b of visibleBoundaries()) {
    const d = Math.abs(xToTime(x, ov) - b.t);
    if (d < bestD) { best = b; bestD = d; }
  }
  return best;
}

const ovEl = document.getElementById("overlay");

ovEl.onmousedown = (e) => {
  if (!decodedAudio) return;
  const b = hitBoundary(e.offsetX, ovEl);
  if (b) {
    pushUndo();
    dragState = { mode: "boundary", b };
  } else if (e.shiftKey) {
    dragState = { mode: "select", anchor: xToTime(e.offsetX, ovEl) };
    selection = { start: dragState.anchor, end: dragState.anchor };
  } else {
    dragState = { mode: "maybe-seek", x0: e.offsetX };
  }
};

ovEl.onmousemove = (e) => {
  if (!dragState) {
    ovEl.style.cursor = hitBoundary(e.offsetX, ovEl) ? "ew-resize"
      : (e.shiftKey ? "text" : "pointer");
    return;
  }
  const t = Math.max(0, Math.min(decodedAudio?.duration ?? 0,
                                 xToTime(e.offsetX, ovEl)));
  if (dragState.mode === "select") {
    selection = {
      start: Math.min(dragState.anchor, t),
      end: Math.max(dragState.anchor, t),
    };
    $("#snippet-btn").hidden = selection.end - selection.start < 0.02;
    drawOverlay();
  } else if (dragState.mode === "boundary") {
    applyBoundaryDrag(dragState.b, t);
    drawOverlay();
  }
};

function applyBoundaryDrag(b, t) {
  const segs = activeData.segments;
  const seg = segs[b.si];
  if (b.kind === "seg-start") {
    seg.start = Math.min(t, seg.end - 0.02);
    // clamp into the previous segment's end? reference allows overlap; keep free
    if (seg.words && seg.words.length) {
      seg.words[0].start = Math.min(seg.words[0].start, seg.start);
    }
  } else if (b.kind === "seg-end") {
    seg.end = Math.max(t, seg.start + 0.02);
  } else if (b.kind === "word") {
    const w = seg.words[b.wi];
    const prev = seg.words[b.wi - 1];
    const lo = prev ? prev.start + 0.01 : seg.start;
    const hi = w.end - 0.01;
    w.start = Math.max(lo, Math.min(hi, t));
    if (prev) prev.end = w.start;  // adjacent words stay contiguous
  }
}

ovEl.onmouseup = async (e) => {
  if (!dragState) return;
  const st = dragState;
  dragState = null;
  if (st.mode === "maybe-seek") {
    if (Math.abs(e.offsetX - st.x0) < 4) seek(xToTime(e.offsetX, ovEl));
    return;
  }
  if (st.mode === "boundary") {
    activeData.segments.sort((a, b2) => a.start - b2.start);
    await saveSegments();
    render();
  }
};

ovEl.onmouseleave = () => {
  if (dragState?.mode === "boundary") {
    saveSegments().then(render);
  }
  dragState = null;
};

// wheel zoom centered on the cursor
ovEl.onwheel = (e) => {
  if (!decodedAudio) return;
  e.preventDefault();
  const c = xToTime(e.offsetX, ovEl);
  setZoom(e.deltaY < 0 ? 1.25 : 0.8, c);
};

// snippet export: selection -> 16-bit WAV download (reference snippets
// :3756-3830)
$("#snippet-btn").onclick = () => {
  if (!selection || !decodedAudio) return;
  const { data, sr } = decodedAudio;
  const a = Math.floor(selection.start * sr);
  const b = Math.min(data.length, Math.floor(selection.end * sr));
  const n = b - a;
  const buf = new ArrayBuffer(44 + n * 2);
  const dv = new DataView(buf);
  const wstr = (off, s) => { for (let i = 0; i < s.length; i++) dv.setUint8(off + i, s.charCodeAt(i)); };
  wstr(0, "RIFF"); dv.setUint32(4, 36 + n * 2, true); wstr(8, "WAVE");
  wstr(12, "fmt "); dv.setUint32(16, 16, true); dv.setUint16(20, 1, true);
  dv.setUint16(22, 1, true); dv.setUint32(24, sr, true);
  dv.setUint32(28, sr * 2, true); dv.setUint16(32, 2, true);
  dv.setUint16(34, 16, true);
  wstr(36, "data"); dv.setUint32(40, n * 2, true);
  for (let i = 0; i < n; i++) {
    dv.setInt16(44 + i * 2, Math.max(-32768, Math.min(32767,
      Math.round(data[a + i] * 32767))), true);
  }
  const blob = new Blob([buf], { type: "audio/wav" });
  const aEl = document.createElement("a");
  aEl.href = URL.createObjectURL(blob);
  const base = (activeData.file_name || "audio").replace(/\.[^/.]+$/, "");
  aEl.download = `${base}_${selection.start.toFixed(2)}-${selection.end.toFixed(2)}.wav`;
  aEl.click();
  URL.revokeObjectURL(aEl.href);
};

$("#edit-mode").onchange = drawOverlay;

// ---------------------------------------------------------------- exports

document.querySelectorAll("#export-row button").forEach((btn) => {
  btn.onclick = async () => {
    if (!activeId) return;
    const fmt = btn.dataset.fmt;
    const resp = await fetch(`/api/history/${activeId}/export?format=${fmt}`);
    const blob = await resp.blob();
    const a = document.createElement("a");
    a.href = URL.createObjectURL(blob);
    const base = (activeData.file_name || "transcript").replace(/\.[^/.]+$/, "");
    const ext = { textgrid: "TextGrid" }[fmt] || fmt;
    a.download = `${base}.${ext}`;
    a.click();
    URL.revokeObjectURL(a.href);
  };
});

// ---------------------------------------------------------------- citation

$("#citation-toggle").onclick = (e) => {
  e.preventDefault();
  $("#citation-body").hidden = !$("#citation-body").hidden;
};
$("#citation-copy").onclick = () => {
  navigator.clipboard?.writeText($("#citation-text").textContent);
  $("#citation-copy").textContent = "Copied!";
  setTimeout(() => { $("#citation-copy").textContent = "Copy"; }, 1200);
};

// ---------------------------------------------------------------- wiring

$("#file-input").onchange = (e) => {
  if (e.target.files.length) uploadFiles([...e.target.files]);
};
$("#folder-input").onchange = (e) => {
  // folder select (reference folder upload): keep only audio files
  const ok = [...e.target.files].filter((f) =>
    /\.(wav|mp3|flac|ogg|m4a|aiff)$/i.test(f.name));
  if (ok.length) uploadFiles(ok);
};
const dz = $("#drop-zone");
dz.ondragover = (e) => { e.preventDefault(); dz.classList.add("drag"); };
dz.ondragleave = () => dz.classList.remove("drag");
dz.ondrop = (e) => {
  e.preventDefault();
  dz.classList.remove("drag");
  if (e.dataTransfer.files.length) uploadFiles([...e.dataTransfer.files]);
};

// search overlay: filter + highlight + jump between matches
const searchBox = document.createElement("input");
searchBox.id = "search-box";
searchBox.placeholder = "Search (press /, Enter jumps)";
$("#viz-controls").appendChild(searchBox);
const searchCount = document.createElement("span");
searchCount.id = "search-count";
$("#viz-controls").appendChild(searchCount);
let searchHits = [];
let searchPos = -1;

searchBox.oninput = () => {
  const q = searchBox.value.toLowerCase();
  searchHits = [];
  document.querySelectorAll(".segment").forEach((el, i) => {
    const hit = !q || el.textContent.toLowerCase().includes(q);
    el.style.display = hit ? "" : "none";
    el.classList.toggle("search-hit", Boolean(q) && hit);
    if (q && hit) searchHits.push(el);
  });
  searchPos = -1;
  searchCount.textContent = searchBox.value
    ? `${searchHits.length} match${searchHits.length === 1 ? "" : "es"}` : "";
};
searchBox.onkeydown = (e) => {
  if (e.key === "Enter" && searchHits.length) {
    e.preventDefault();
    searchPos = (searchPos + 1) % searchHits.length;
    searchHits[searchPos].scrollIntoView({ block: "center",
                                           behavior: "smooth" });
    searchHits.forEach((el, i) =>
      el.classList.toggle("search-current", i === searchPos));
  }
  if (e.key === "Escape") { searchBox.value = ""; searchBox.oninput(); searchBox.blur(); }
};

// playback speed menu (reference speed menu 0.25-2x)
const speedSel = document.createElement("select");
speedSel.id = "speed-select";
for (const s of [0.25, 0.5, 0.75, 1, 1.25, 1.5, 2]) {
  const o = document.createElement("option");
  o.value = s;
  o.textContent = `${s}×`;
  if (s === 1) o.selected = true;
  speedSel.appendChild(o);
}
$("#viz-controls").appendChild(speedSel);
speedSel.onchange = () => { $("#audio").playbackRate = +speedSel.value; };

// translation toggle (auto by default per detected languages)
const trBtn = document.createElement("button");
trBtn.id = "tr-toggle";
trBtn.textContent = "Translations: auto";
$("#viz-controls").appendChild(trBtn);
trBtn.onclick = () => {
  showTranslations = showTranslations === null ? true
    : (showTranslations ? false : null);
  trBtn.textContent = `Translations: ${
    showTranslations === null ? "auto" : (showTranslations ? "on" : "off")}`;
  renderTranscript();
};

// keyboard shortcut map (reference index.html:561-616)
document.addEventListener("keydown", (e) => {
  if (e.target.tagName === "INPUT" || e.target.tagName === "TEXTAREA" ||
      e.target.tagName === "SELECT") return;
  const audio = $("#audio");
  const mod = e.ctrlKey || e.metaKey;
  if (mod && !e.shiftKey && e.key.toLowerCase() === "z") {
    e.preventDefault(); undo(); return;
  }
  if (mod && (e.key.toLowerCase() === "y" ||
              (e.shiftKey && e.key.toLowerCase() === "z"))) {
    e.preventDefault(); redo(); return;
  }
  if (e.key === " ") {
    e.preventDefault();
    if (audio.paused) audio.play(); else audio.pause();
  } else if (e.key === "ArrowLeft") {
    audio.currentTime = Math.max(0, audio.currentTime - (e.shiftKey ? 10 : 5));
  } else if (e.key === "ArrowRight") {
    audio.currentTime += e.shiftKey ? 10 : 5;
  } else if (e.key === "[") {
    navigateSegment(-1);
  } else if (e.key === "]") {
    navigateSegment(1);
  } else if (e.key.toLowerCase() === "l") {
    toggleLoop();
  } else if (e.key === "+" || e.key === "=") {
    setZoom(2);
  } else if (e.key === "-") {
    setZoom(0.5);
  } else if (e.key === "/") {
    e.preventDefault();
    searchBox.focus();
  } else if (e.key === "?") {
    e.preventDefault();
    $("#shortcuts-modal").hidden = !$("#shortcuts-modal").hidden;
  } else if (e.key === "Escape") {
    $("#shortcuts-modal").hidden = true;
  }
});

$("#shortcuts-close").onclick = () => { $("#shortcuts-modal").hidden = true; };
$("#shortcuts-modal").onclick = (e) => {
  if (e.target.id === "shortcuts-modal") e.target.hidden = true;
};

window.addEventListener("resize", () => { syncOverlaySize(); redrawViz(); });

async function boot() {
  await refreshHistory();
  syncOverlaySize();
  // first visit with empty history: show the built-in demo transcript
  if (!document.querySelectorAll("#history li:not(.demo)").length) {
    openDemo();
  }
}

boot();
