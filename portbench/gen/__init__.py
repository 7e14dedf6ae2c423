"""portbench's general traffic generators, each driven by a configuration
file and a traffic-mix file."""
