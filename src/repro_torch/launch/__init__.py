"""Entry points: the ``compress``, ``serve`` and ``train`` CLIs and the
step builders (``steps.py``)."""
