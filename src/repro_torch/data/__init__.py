"""The synthetic data pipeline of the port and its DHash dedup
(``pipeline``)."""
