"""idle_share.attack: the share of the traced slice in which no operation
ran on the device, one minus the union of device activity over the
slice's length (%)."""


def read(obs):
    if not obs.ops or obs.window_s <= 0:
        return None
    return 100.0 * (1.0 - obs.busy_s / obs.window_s)
