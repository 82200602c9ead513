"""Keyed folds on the device.

Port of ``dampr_tpu/parallel``'s single-device fold (:mod:`.shuffle`); the
mesh, the exchange and the collectives across cards are a later slice.
"""
