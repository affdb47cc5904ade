"""One module a model family: ``families/<family>.py``, found by a
configuration's ``"family"``.  It holds all that one kind of model decides
(``families/toucan_tts.py`` lists what that is); the harness holds what
every model shares."""
