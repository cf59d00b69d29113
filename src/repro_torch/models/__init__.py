"""The model side of the port: the decode half of the reference's
``models/`` for attention blocks (``layers``, ``attention``,
``transformer``, ``model``)."""
