"""Core of the port: sensors, timelines, calibration, the sensor bank and
the streaming monitor (:mod:`.stream`)."""
