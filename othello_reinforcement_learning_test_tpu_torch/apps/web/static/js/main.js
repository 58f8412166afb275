// App controller: wires clicks -> moves -> auto AI reply (500 ms delay,
// like the reference client), hint overlay, model management.

class OthelloApp {
  constructor() {
    this.ui = new UI();
    this.board = new OthelloBoard(document.getElementById("board"));
    this.board.onCellClick = (pos) => this.onCellClick(pos);
    this.autoAi = true;
    this._bind();
    this._init();
  }

  _bind() {
    this.ui.buttons.newGame.addEventListener("click", () => this.newGame());
    this.ui.buttons.undo.addEventListener("click", () => this.undo());
    this.ui.buttons.ai.addEventListener("click", () => this.aiMove());
    this.ui.buttons.hint.addEventListener("click", () => this.hint());
    this.ui.buttons.load.addEventListener("click", () => this.loadModel());
    this.ui.buttons.pass.addEventListener("click", () => this.passMove());
    this.ui.simsSlider.addEventListener("change", async (e) => {
      const res = await API.setSimulations(Number(e.target.value));
      this.ui.setSimulations(res.num_simulations);
    });
  }

  async _init() {
    try {
      const [state, models, sims] = await Promise.all([
        API.state(), API.models(), API._fetch("/api/ai/simulations"),
      ]);
      this.render(state);
      this.ui.setModels(models.models, models.current);
      this.ui.setSimulations(sims.num_simulations);
    } catch (err) {
      this.ui.setMessage(`init failed: ${err.message}`, true);
    }
  }

  render(state, hints = null) {
    this.state = state;
    this.board.update(state, hints);
    this.ui.update(state);
  }

  async newGame() {
    this.render(await API.newGame());
    this.ui.setMessage("");
  }

  async undo() {
    try {
      const res = await API.undo();
      this.render(res.state);
    } catch (err) {
      this.ui.setMessage(err.message, true);
    }
  }

  async onCellClick(pos) {
    if (!this.state || this.state.is_game_over || this.state.is_ai_thinking) return;
    if (!this.state.legal_moves.includes(pos)) return;
    try {
      const res = await API.move(pos);
      this.render(res.state);
      this.ui.setMessage("");
      if (this.autoAi && this.state.model_loaded && !res.state.is_game_over) {
        setTimeout(() => this.aiMove(), 500);
      }
    } catch (err) {
      this.ui.setMessage(err.message, true);
    }
  }

  async passMove() {
    const passAction = this.state.board_size * this.state.board_size;
    try {
      const res = await API.move(passAction);
      this.render(res.state);
      this.ui.setMessage("passed");
      if (this.autoAi && this.state.model_loaded && !res.state.is_game_over) {
        setTimeout(() => this.aiMove(), 500);
      }
    } catch (err) {
      this.ui.setMessage(err.message, true);
    }
  }

  async aiMove() {
    try {
      await API.aiMove();
      this.render({ ...this.state, is_ai_thinking: true });
      const status = await API.waitForAiMove();
      if (status.error) this.ui.setMessage(status.error, true);
      this.render(await API.state());
    } catch (err) {
      this.ui.setMessage(err.message, true);
      this.render(await API.state());
    }
  }

  async hint() {
    try {
      const res = await API.hint();
      this.render(this.state, res.evaluations);
      this.ui.setMessage(`hint: ${res.num_simulations} simulations`);
    } catch (err) {
      this.ui.setMessage(err.message, true);
    }
  }

  async loadModel() {
    const path = this.ui.modelSelect.value;
    if (!path) { this.ui.setMessage("select a model first", true); return; }
    this.ui.setMessage("loading model…");
    try {
      await API.loadModel(path);
      this.render(await API.state());
      this.ui.setMessage("model loaded");
    } catch (err) {
      this.ui.setMessage(err.message, true);
    }
  }
}

window.addEventListener("DOMContentLoaded", () => { window.app = new OthelloApp(); });
