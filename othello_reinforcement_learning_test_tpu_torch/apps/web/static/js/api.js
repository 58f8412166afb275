// REST client for the Othello backend (same endpoints as the reference
// web API; polling-based async AI moves).

const API = {
  async _fetch(path, options = {}) {
    const res = await fetch(path, {
      headers: { "Content-Type": "application/json" },
      ...options,
    });
    const data = await res.json().catch(() => ({}));
    if (!res.ok) {
      const detail = data.detail || data.error || `HTTP ${res.status}`;
      throw new Error(detail);
    }
    return data;
  },

  newGame() { return this._fetch("/api/game/new", { method: "POST" }); },
  state() { return this._fetch("/api/game/state"); },

  move(position) {
    return this._fetch("/api/game/move", {
      method: "POST",
      body: JSON.stringify({ position }),
    });
  },

  undo() { return this._fetch("/api/game/undo", { method: "POST" }); },
  aiMove() { return this._fetch("/api/game/ai-move", { method: "POST" }); },
  aiStatus() { return this._fetch("/api/game/ai-status"); },
  hint() { return this._fetch("/api/game/hint"); },

  loadModel(path) {
    return this._fetch("/api/ai/load-model", {
      method: "POST",
      body: JSON.stringify({ path }),
    });
  },

  setSimulations(n) {
    return this._fetch("/api/ai/simulations", {
      method: "PUT",
      body: JSON.stringify({ num_simulations: n }),
    });
  },

  models() { return this._fetch("/api/ai/models"); },

  // Poll ai-status every 200 ms until the AI finishes (60 s timeout),
  // mirroring the reference client's waitForAiMove.
  async waitForAiMove(timeoutMs = 60000) {
    const t0 = Date.now();
    for (;;) {
      const status = await this.aiStatus();
      if (!status.is_thinking) return status;
      if (Date.now() - t0 > timeoutMs) throw new Error("AI move timed out");
      await new Promise((r) => setTimeout(r, 200));
    }
  },
};
