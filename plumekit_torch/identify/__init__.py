"""Plume identification: the threshold sweep on the device
(:mod:`.pipeline`), fire location (:mod:`.locate`), the rg, basic and
gaussian detectors (:mod:`.rg`, :mod:`.basic`, :mod:`.gaussian`), the
config-typed :func:`.api.identify`, and the blob baseline (:mod:`.blob`)."""
