// UI state: turn indicator, stone counts, messages, model select, slider.

class UI {
  constructor() {
    this.turn = document.getElementById("turn-indicator");
    this.blackCount = document.getElementById("black-count");
    this.whiteCount = document.getElementById("white-count");
    this.message = document.getElementById("message");
    this.aiStatus = document.getElementById("ai-status");
    this.modelSelect = document.getElementById("model-select");
    this.simsSlider = document.getElementById("sims-slider");
    this.simsValue = document.getElementById("sims-value");
    this.buttons = {
      newGame: document.getElementById("btn-new"),
      undo: document.getElementById("btn-undo"),
      ai: document.getElementById("btn-ai"),
      hint: document.getElementById("btn-hint"),
      pass: document.getElementById("btn-pass"),
      load: document.getElementById("btn-load"),
    };
  }

  update(state) {
    if (state.is_game_over) {
      const w = state.winner;
      this.turn.textContent =
        w === 1 ? "Game over — Black wins!" :
        w === -1 ? "Game over — White wins!" : "Game over — Draw";
    } else {
      this.turn.textContent =
        state.current_player === 1 ? "Black ● to move" : "White ○ to move";
    }
    this.blackCount.textContent = state.black_count;
    this.whiteCount.textContent = state.white_count;
    this.buttons.undo.disabled = !state.can_undo || state.is_ai_thinking;
    this.buttons.ai.disabled = !state.model_loaded || state.is_ai_thinking ||
      state.is_game_over;
    this.buttons.hint.disabled = !state.model_loaded || state.is_ai_thinking;
    // pass is the only legal action when no square is playable
    const passAction = state.board_size * state.board_size;
    const mustPass = !state.is_game_over &&
      state.legal_moves.length === 1 && state.legal_moves[0] === passAction;
    this.buttons.pass.hidden = !mustPass;
    this.buttons.pass.disabled = state.is_ai_thinking;
    this.aiStatus.textContent = state.is_ai_thinking ? "AI thinking…" :
      (state.model_loaded ? `model: ${state.model_path || "(loaded)"}` :
        "no model loaded");
  }

  setMessage(text, isError = false) {
    this.message.textContent = text || "";
    this.message.classList.toggle("error", isError);
  }

  setModels(models, current) {
    this.modelSelect.innerHTML = "";
    const none = document.createElement("option");
    none.value = ""; none.textContent = "(select model)";
    this.modelSelect.appendChild(none);
    for (const m of models) {
      const opt = document.createElement("option");
      opt.value = m;
      opt.textContent = m.split("/").slice(-1)[0];
      if (m === current) opt.selected = true;
      this.modelSelect.appendChild(opt);
    }
  }

  setSimulations(n) {
    this.simsSlider.value = n;
    this.simsValue.textContent = n;
  }
}
