"""The model side of the port: the decode half of the reference's
``models/`` for attention blocks, dense or with experts (``layers``,
``attention``, ``moe``, ``transformer``, ``model``)."""
