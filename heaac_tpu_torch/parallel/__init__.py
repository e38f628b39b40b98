"""Decode across several cards and several processes.

Counterpart of ``heaac_tpu/parallel/``: ``sharding`` splits each stream
group over the cards of one process, ``multihost`` runs one process per
host (or card) and all-reduces the decode metrics over
``torch.distributed``.
"""
