"""Device operations (kernels, copies, fills) of one traced ply (its
search call and the play of its actions), over its simulations: the
program's launches, which the host pays for one by one."""


def read(rec):
    p = rec.device_pass
    if not p.complete or not p.ops:
        return None
    return len(p.ops) / rec.traffic["num_simulations"]
