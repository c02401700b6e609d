"""``python -m efficientdet_tpu_torch.eval``: the evaluation driver
(``driver.py``)."""

from .driver import main

main()
