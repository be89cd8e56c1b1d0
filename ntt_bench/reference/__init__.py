"""The benchmark's plain reference: plain torch, no code, table or weight of the
port (`exact.py`, `products.py`), and its float64 control (`float64.py`)."""
