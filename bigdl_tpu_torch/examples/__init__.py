"""Example programs of the port (counterparts of the JAX package's
``examples/``): ``wide_and_deep``, ``tree_lstm_sentiment``,
``text_classification``, ``language_model`` and ``udf_predictor``.
Each main takes its JAX counterpart's flags and prints its lines,
draws its data from the same ``numpy.random`` calls, and takes
``--device`` (``cuda`` by default; ``cpu`` runs the plain PyTorch
path)."""
