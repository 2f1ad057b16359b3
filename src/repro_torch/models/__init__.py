"""Dense attention + MLP language models: config, primitives, layers
and the LM assembly (``model.py``)."""
