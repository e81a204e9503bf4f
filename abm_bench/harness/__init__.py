"""The harness: discovery by name, the general loops, the device trace and the check."""
