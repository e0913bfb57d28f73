"""Test utilities (reference: ``pkg/gofr/testutil``).

The port's copy of the reference's in-process MQTT 3.1.1 broker
(``gofr_tpu/testutil/mqtt_broker.py``), which the MQTT client is tested
against and which ``chip_smoke.py`` runs beside an App on the card.
"""
