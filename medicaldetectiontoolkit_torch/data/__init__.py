"""Host-side data handling of the port: seg-to-box conversion and the test-time loader utilities."""
