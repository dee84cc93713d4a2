"""Occupancy SSC metrics, indoor detection mAP and the eval loop."""
