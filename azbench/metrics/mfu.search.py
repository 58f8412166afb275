"""The whole step's share of the card's peaks over the timed window: the
least time the published peaks allow for the network arithmetic the
window's search calls needed (every live game's leaf once a simulation and
its root once a call; the tower at the int8 peak, the stem and heads at
the bf16 peak), over the window's seconds. Counted from the shapes and the
roots searched, never from what the program launched."""

from azbench.yardstick import forward_least_s


def read(rec):
    cfg, card = rec.config, rec.card
    if card is None or rec.positions == 0:
        return None
    boards = rec.positions * (rec.traffic["num_simulations"] + 1)
    least = boards * forward_least_s(card, cfg["num_blocks"], cfg["num_filters"],
                                     cfg["board_size"], cfg["value_hidden"])
    return 100.0 * least / rec.window_s
