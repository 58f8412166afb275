// Canvas board renderer: grid, stones, legal-move dots, last-move marker,
// 0-100 hint overlay.

class OthelloBoard {
  constructor(canvas, size = 8) {
    this.canvas = canvas;
    this.ctx = canvas.getContext("2d");
    this.size = size;
    this.cell = canvas.width / size;
    this.state = null;
    this.hints = null; // {position: 0-100}
    this.onCellClick = null;
    canvas.addEventListener("click", (e) => this._click(e));
  }

  _click(e) {
    if (!this.onCellClick) return;
    const rect = this.canvas.getBoundingClientRect();
    const x = (e.clientX - rect.left) * (this.canvas.width / rect.width);
    const y = (e.clientY - rect.top) * (this.canvas.height / rect.height);
    const col = Math.floor(x / this.cell);
    const row = Math.floor(y / this.cell);
    if (row >= 0 && row < this.size && col >= 0 && col < this.size) {
      this.onCellClick(row * this.size + col);
    }
  }

  update(state, hints = null) {
    this.state = state;
    this.hints = hints;
    if (state && state.board_size) {
      this.size = state.board_size;
      this.cell = this.canvas.width / this.size;
    }
    this.draw();
  }

  draw() {
    const { ctx, cell, size } = this;
    ctx.clearRect(0, 0, this.canvas.width, this.canvas.height);

    // grid
    ctx.strokeStyle = "#145c34";
    ctx.lineWidth = 1.5;
    for (let i = 0; i <= size; i++) {
      ctx.beginPath();
      ctx.moveTo(i * cell, 0); ctx.lineTo(i * cell, size * cell); ctx.stroke();
      ctx.beginPath();
      ctx.moveTo(0, i * cell); ctx.lineTo(size * cell, i * cell); ctx.stroke();
    }

    if (!this.state) return;
    const board = this.state.board;
    const legal = new Set(this.state.legal_moves || []);

    for (let r = 0; r < size; r++) {
      for (let c = 0; c < size; c++) {
        const v = board[r][c];
        const cx = c * cell + cell / 2;
        const cy = r * cell + cell / 2;
        if (v !== 0) {
          const grad = ctx.createRadialGradient(
            cx - cell * 0.12, cy - cell * 0.12, cell * 0.08, cx, cy, cell * 0.42);
          if (v === 1) { grad.addColorStop(0, "#3a3a3a"); grad.addColorStop(1, "#050505"); }
          else { grad.addColorStop(0, "#ffffff"); grad.addColorStop(1, "#cfcfcf"); }
          ctx.fillStyle = grad;
          ctx.beginPath();
          ctx.arc(cx, cy, cell * 0.40, 0, Math.PI * 2);
          ctx.fill();
        }
        const pos = r * size + c;
        if (v === 0 && legal.has(pos)) {
          ctx.fillStyle = "rgba(255,255,255,0.25)";
          ctx.beginPath();
          ctx.arc(cx, cy, cell * 0.10, 0, Math.PI * 2);
          ctx.fill();
        }
        if (this.hints && pos in this.hints) {
          const score = this.hints[pos];
          const hue = Math.round((score / 100) * 120); // red -> green
          ctx.fillStyle = `hsla(${hue}, 80%, 55%, 0.85)`;
          ctx.font = `${Math.round(cell * 0.30)}px sans-serif`;
          ctx.textAlign = "center";
          ctx.textBaseline = "middle";
          ctx.fillText(String(score), cx, cy);
        }
      }
    }

    // last move marker
    const last = this.state.last_move;
    if (last !== null && last !== undefined && last < size * size) {
      const r = Math.floor(last / size), c = last % size;
      ctx.strokeStyle = "#4fc3f7";
      ctx.lineWidth = 2.5;
      ctx.beginPath();
      ctx.arc(c * cell + cell / 2, r * cell + cell / 2, cell * 0.46, 0, Math.PI * 2);
      ctx.stroke();
    }
  }
}
