"""One module a client: ``clients/<client>.py``, found by a mix's
``"client"``, whose ``CLIENT`` subclasses ``harness.serve.Client``."""
