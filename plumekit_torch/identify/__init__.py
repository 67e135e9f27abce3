"""Plume identification: the rg threshold sweep on the device
(:mod:`.pipeline`), fire location (:mod:`.locate`) and the rg driver
(:mod:`.rg`)."""
