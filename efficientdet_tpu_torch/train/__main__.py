"""``python -m efficientdet_tpu_torch.train``: the training driver
(``driver.py``)."""

from .driver import main

main()
