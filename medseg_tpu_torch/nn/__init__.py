"""Neural-network building blocks."""
