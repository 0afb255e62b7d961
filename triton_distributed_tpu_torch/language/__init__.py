"""The device-side communication runtime's host half."""
