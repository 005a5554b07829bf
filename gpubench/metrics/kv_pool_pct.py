"""The engine's paged KV pool (``engine/paging.py``): the mean share of the
pool's pages allocated over the window, in percent, from the port's
``rdb_decode_kv_page_occupancy`` gauge sampled every quarter second."""


def read(window):
    shares = window.pool_shares()
    return 100.0 * sum(shares) / len(shares) if shares else None
