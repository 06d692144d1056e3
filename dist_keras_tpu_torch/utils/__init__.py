"""Device resolution, params trees and the numpy parameter bridge."""
