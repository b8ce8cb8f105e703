"""StreamSim's wave program and the framework-free types it runs on."""
