"""products_per_s (end to end, host clock): negacyclic products completed in
the window over the window's seconds. A PBS step counts each accumulated
term d·K as one product, 4 a ciphertext."""


def read(win):
    if win.window_s <= 0:
        return None
    return (win.calls - win.failed) * win.products_per_call / win.window_s
